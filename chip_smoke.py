#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Phases, each of which raises (and so exits non-zero) when it fails:

1. the card: its name and power limit, as ``nvidia-smi`` prints them;
2. the build: ``nvcc`` compiles the five kernel libraries from their
   ``csrc/`` (powercap, flash_attention, decode_attention, moe_gmm,
   ssd_scan with K8b), every source at once;
3. each powercap kernel against its plain PyTorch version on the card, in
   fp64, at the main paths' shapes, timed with CUDA events (median of 20)
   and, for K1 and K2, by their device time under ``torch.profiler`` (the
   profile tool's reading), with K2's plan (cluster size, threads, shared
   memory): K1 and K2 at paths A, B, D and R, at path U's widest pad
   bucket ``(12, 1024, 16)`` and at path C's ``(2, 16384, 16)``, K2 at
   paths V and W (one cell) and on one cell of 10,000 hosts (the
   reference's ``datacenter_cell``), each with round counts and ``did``
   flags equal to the plain version's; K3 at paths V and W and on a
   ragged case
   (empty hosts, a host whose floors exceed its capacity, a 256-wide row,
   huge values in the rows next to each row); K3 and K2 (bitwise) at each
   of path E's shapes, on the inputs that E's CPU runs of ``headroom``
   and ``flexible`` on the legacy engine gave them; then rows of every shape
   the row routine has: K1 and K2 at 3, 40, 100 and 300 slots a row, K3
   at rows of 300 and 1,000 items (streamed from memory);
4. main path A, the ``sweep_grid`` grid (32 cells x 100 hosts x 10 VMs),
   through ``run_sweep_batched`` (the exact pack) on the card, held against
   the same grid run on the CPU (plain versions), with every kernel's
   launch count checked;
5. main path B, 16 cells x 1000 hosts x 10 VMs over 120 ticks, with one
   spec's two cells held against a CPU run of those two cells alone;
6. main path V, the top rung of the ``sweep_scale`` ladder (1000 hosts x
   10 VMs, burst, 60 ticks, policies cpc and static) through
   ``run_sweep(..., engine="vector")`` on the card, held against the same
   cells on the CPU and against the batched engine on the card, with the
   launch counts of K3 (one a tick, two more for each committed balance's
   note) and K2 (one a cpc invocation) checked;
6b. main path D, ``sweep_grid_dpm``'s grid (``benchmarks/run.py:282``,
   32 cells x 100 hosts x 10 VMs: churn none, dpm, maintenance and
   failure, 1500 s at 15 s ticks, slot slack 1.5) through
   ``run_sweep_batched`` on the card (the churn program: DPM, Powercap
   Redistribution, evacuations, scripted events), held against the same
   grid on the CPU: exact counts, payload and energy 1e-9, final power
   states, occupancy and caps equal, the budget within 1e-6, power-offs,
   power-ons and
   vMotions in the grid, K1's and K2's launches equal to the CPU run's
   plain calls; its cells/s, branch reads a tick, launches a tick and
   the device's idle share (one traced run) printed;
6c. path W, the vector engine on that grid's first two ``dpm`` specs and
   its burst homogeneous ``maintenance`` and ``failure`` specs, cpc and
   static, held against the CPU and against path D, K3 and K2 launches
   equal to the CPU run's plain calls, ticks/s printed;
6d. path R, ``row_contention_specs(sizes=(100,))`` (a two-row budget
   tree) on both engines, each held against the CPU, ``over_tree``
   within 1e-6;
6e. main path G, ``sweep_grid_rules``'s grid (``benchmarks/run.py:347``,
   32 cells x 100 hosts x 10 VMs: rules violation_burst and cap_blocked,
   4 spikes, both host mixes, 600 s at 10 s ticks, slot slack 1.5), and
   main path X, ``sweep_grid_timed``'s (``:409``: churn timed_churn and
   failure_cascade, rules none and violation_burst, gated timed vMotions
   of 2 slots a host and a bandwidth of 8) through ``run_sweep_batched``
   on the card (the churn program with constraint
   correction, the hill-climb balancer and, on X, the in-flight table),
   each held against the same grid on the CPU as path D is (the counts
   the grid must show: cap changes and vMotions, on X power-ons too), K1
   and K2 launches equal to the CPU run's plain calls; cells/s, branch and
   migration reads a tick, launches a tick and the idle share printed;
   then K1 at the balancer's shapes (its ``(32, 100, 15)`` entitlement
   waterfill and its ``(32, 2, 15)`` pair refill, 100 trips) on the
   inputs G's and X's CPU runs gave it, bitwise against its plain
   version, timed, with device time and bound;
6f. path Q, both benchmarks' sequential baselines (``specs[:2]`` of each
   grid, cpc and static: 8 cells) on the vector engine (K3 a tick; K1 and
   K2 in the manager), held against the CPU, K1-K3 launches equal to the
   CPU run's plain calls, K1 at the manager's balancer shapes and K3 and
   K2 at Q's against their plain versions;
6g. path E, the paper's evaluation: ``run_all`` of ``headroom``,
   ``standby`` and ``flexible`` (three policies each) on the legacy and the
   vector engine on the card (18 runs), each held against the same run on
   the CPU (counts and event strings exact, accumulators and window
   accumulators 1e-9, final states and placement equal, K1-K3 launches
   equal to its plain calls), legacy against vector on the card; Table
   II and the Table III-V lines printed and held to EXPERIMENTS.md's;
6h. path U, the bucketed front door: ``run_sweep(scenario_families(),
   engine="batch", on_unsupported="fallback")`` (12 specs of 10, 100 and
   1000 hosts x 3 policies, 120 ticks: pad buckets (16, 16), (128, 16)
   and (1024, 16), each 120 K1 and 3 K2 launches) and one cell on another
   time grid, which falls back to the vector engine with its warning;
   held against the CPU run of the same call (exact counts, 1e-9, final
   states) and against ``run_sweep_batched`` on the card (equal counts,
   1e-12); the bucket records, launches a bucket and idle share printed;
6i. path C, ``datacenter_cell`` (10,000 hosts x 10 VMs, 230 W a host,
   burst, 600 s at 30 s, cpc and static) through ``run_sweep(...,
   engine="batch")``: one pad bucket of (16384, 16), held against its CPU
   run, the cpc cell changing caps; wall, bucket record and idle share
   printed.  The CPU runs of E, U and C run in two worker processes from
   the build on, while the card runs the paths before them;
6j. the budget service: the ``budget_service`` benchmark's replay (50
   hosts, the two-row tree, 4,000 events from seed 0), headroom against
   brute force within 1e-9 and the reference's decision and error counts,
   its host latencies printed beside the card's name and power limit;
7. K4 (flash attention forward) and K6 (flash decoding) against their
   plain versions on the card: K4 at path S's prefill (8 x 512 tokens,
   32 query and 8 KV heads of 128, bf16), on bf16 cases of its
   tensor-core regime (ragged lengths 100/164 with a query offset of 64,
   the same as views into caches whose positions past Skv and features
   past D hold NaN, MQA, non-causal at D 112; each two launches bitwise
   equal) and on a float32 case with a query offset and lengths that are
   no multiple of its blocks (the CUDA-core kernel), each in the regime
   its plan must choose; K6 (one kernel for both dtypes: split-K
   partials and the combine in one call) over a 1024-position cache with
   ragged lengths in bf16 and float32, a case whose splits are all fully
   masked but one, and a bf16 cache whose position pitch is no multiple
   of 16 bytes (element copies), each two launches bitwise equal, its plan's
   shared memory the library's own count.  Tolerances: 2e-5 in float32,
   2e-2 in bf16, relative to the values' scale (the absolute term is the
   tolerance times the RMS of the plain output where that is under 1).
   Each is timed beside its plain version and
   ``scaled_dot_product_attention`` on the same inputs;
8. main path S, ``launch.serve``'s driver at granite-8b's full width and
   depth in bf16 (2 replicas, 16 requests, prompts of 512, 32 tokens, a
   1024-position cache): the exact launch counts (K4 once a layer a
   prefill, K6 once a layer a decode step, K1, K2 and K3 as the same cap
   event's CPU run calls their plain versions), the routing, caps and note of the cap event identical to the
   CPU run of the same event, and one replica's batch fed back (teacher
   forcing) through the plain versions on the card, logits within 2e-2
   relative L2; then prefill and decode-step times, and the graph phase
   (:func:`check_decode_graph`, on paths S, M, P, H, I and Y alike):
   ``generate``'s decode steps replayed from one captured CUDA graph a
   call, greedy tokens and logits and teacher-forced logits bitwise equal
   to the eager steps', the capture's, the instantiation's and a replayed
   step's ms beside the eager step's;
9. granite-8b at full width and 4 layers in float32: identical greedy
   tokens through the kernels and through the plain versions, logits
   within 1e-4 relative L2;
10. K5 (flash attention backward) against its plain version on the card
    in eight cases: path T's layer (4 x 4096 tokens, 36/36 heads of 64,
    causal, bf16), GQA (8 x 512, 32/8 heads of 128, bf16), MQA in float32
    with a query offset of 64 and lengths 100/164 (also against autograd
    of ``attention_ref``), float32 non-causal, and phase 7's four bf16
    cases; bf16 in the tensor-core regime (two launches bitwise equal),
    float32 on the CUDA cores, as the plan must choose.  Tolerances: 1e-4
    in float32, 2e-2 in bf16, relative to the values' scale as in 7.
    Timed at path T's layer beside its plain version and
    ``scaled_dot_product_attention``'s backward, with K4 at the same
    shape; then K5 at head dims 192 (Nemotron-4-340B's, zero-padded to
    256) and 256 on the CUDA cores (32-row blocks), causal, 2 x 256
    tokens, 8 query heads over 8 and 2 KV heads, bf16 and float32, two
    launches bitwise equal, timed beside SDPA's backward;
11. main path T, ``launch.train``'s driver at MiniCPM-2B's full width in
    bf16 (10 of 40 layers since the sequence layouts' paths joined the
    run, 2.725e9 parameters whole; 6 steps of 4 x 4096 tokens, 2 pods, the budget cut at step 1 and the straggler from step
    2, the final checkpoint in a temporary directory that is removed):
    exact launch counts (K4 twice a layer a step under remat, K5 once a
    layer a step, K1, K2 and K3 as often as the same events' CPU run
    calls their plain versions, outermost calls only), plans and caps
    identical to the same driver's CPU run at the smoke size, finite
    losses and gradient norms, and one batch's loss and gradients through
    the kernels against the plain versions on the card (1e-2 relative and
    5e-2 relative L2); then warm step, layer and AdamW times;
12. MiniCPM-2B at full width and 4 layers in float32: two steps' losses
    and gradients through the kernels within 1e-4 of the plain versions;
13. K7 (the grouped expert GEMM) against its plain version on the card:
    path M's three products in bf16 (its prefill's ``(64, 640, 2048) @
    (64, 2048, 1024)`` and ``(64, 640, 1024) @ (64, 1024, 2048)`` in the
    wide tensor-core regime, a decode step's ``(64, 8, 2048) @ (64, 2048,
    1024)`` in the narrow one), a ragged float32 case at DeepSeekMoE's d_ff
    of 1408 and C = 1 (the CUDA-core kernel), a D that is no multiple of
    the depth tiles, C = 64 and C = 72 at path M's D and F (the regime
    boundary), a bf16 shape whose pitches TMA cannot read (the CUDA-core
    kernel), and a view a regime into a larger allocation whose rows past
    C and columns past D and F hold NaN; each in the regime the plan must
    choose, two launches bitwise equal; tolerances as in 7; each timed
    beside its plain version and ``torch.bmm``; then K4 and K6 at path M's
    shapes (16/16 heads of 128, bf16: K4 on the prefill of 8 x 512, K6 over
    a 1024-position cache), held as in 7 and timed beside their plain
    versions and SDPA, with their bounds;
14. main path M, ``launch.serve``'s driver at OLMoE-1B-7B's full width and
    depth in bf16 (16 layers, 64 experts top-8, 6.919e9 parameters), with
    path S's replicas, requests, prompts, tokens and cache: the exact
    launch counts (K7 three times a layer a forward, K4 once a layer a
    prefill, K6 once a layer a decode step, K1-K3 as the same cap event's
    CPU run calls their plain versions), the cap event identical to its
    CPU run, the first layer's MoE on the path's prefill through K7 and its
    plain version within 2e-2, and one replica's batch fed back through
    the plain versions on the card, logits within 5e-2 relative L2 (the
    reference's MoE bar: routing near ties flips in bf16) with the share
    of top-k sets that differ printed; then prefill and decode-step times;
15. DeepSeekMoE-16B at full width and 4 layers in float32 (shared experts,
    top-6): identical greedy tokens and routing through the kernels and
    through the plain versions, logits within 1e-4 relative L2;
16. K8 (the SSD intra-chunk step) against its plain version on the card:
    at path P's and path H's prefill call in bf16 (8 x 512 tokens, chunk
    256; 80 heads of 64 with N 128, and 112 heads of 64 with N 64; B and C
    one row shared by the heads, as the model passes them) in the
    tensor-core regime, as the plan must choose (its shared memory the
    library's own count), two launches bitwise equal, each timed beside
    its plain version, the same calls with B and C packed (bitwise equal),
    and a float32 scan (the CUDA-core kernels) with a ragged tail and an
    initial state through ``ops.ssd_scan`` against the sequential oracle
    (L 40, chunk 16); tolerance 1e-4 relative to the values' scale;
17. K4, K5 and K6 at head dim 112 (Zamba2-7B's shared attention)
    against their plain versions in bf16 and float32 at path H's shapes:
    K4 and K5 on a prefill of 8 x 512 with 32/32 heads (the tensor cores
    in bf16, the CUDA cores in float32, two launches bitwise equal), K6
    over a 1024-position cache with ragged lengths, at Phi-2's head dim 80
    (32 heads over 512 positions) and on a case whose splits are all fully
    masked but one, two launches bitwise equal each; K4 and K5 at head dim
    80 too (2 x 256 tokens, 8 heads: zero-padded to 112 by their wrappers);
    tolerances as in 7 and 10, the bf16 calls timed beside the plain
    versions and SDPA;
18. main path P, ``launch.serve``'s driver at Mamba2-2.7B's full width and
    depth in bf16 (64 layers, 80 SSD heads of 64, N 128, 2.7e9
    parameters), with path S's replicas, requests, prompts, tokens and
    cache: the exact launch counts (K8 once a layer a prefill, K4-K7 none,
    K1-K3 as the same cap event's CPU run calls their plain versions), the
    cap event identical to its CPU run, one replica's batch fed back
    through the plain versions on the card, logits within 2e-2 relative
    L2; then prefill and decode-step times;
19. main path H, the same at Zamba2-7B's full width and depth (81 layers,
    112 SSD heads of 64, N 64, 13 sites of the shared attention block with
    32 heads of 112, 6.75e9 parameters): K8 once a layer a prefill, K4
    once a site a prefill, K6 once a site a decode step;
20. Mamba2-2.7B at full width and 4 layers and Zamba2-7B at full width
    and 7 layers (one site, then one more layer) in float32: identical
    greedy tokens through the kernels and through the plain versions,
    logits within 1e-4 relative L2;
21. K7's backward (two K7 launches through its autograd Function: dX as
    ``(E, C, F) @ (E, F, D)``, dW as ``(E, D, C) @ (E, C, F)``, reading
    ``W^T`` K-major and ``X^T`` MN-major in place) at path TM's three
    products (OLMoE's gate, up and down at C = 1280) in bf16 (the wide
    regime) and float32 (the CUDA-core kernel), and on views into
    NaN-filled allocations at pitches TMA reads and at pitches it cannot,
    against its plain version (tolerances as in 7 for bf16, 1e-5 in
    float32), each product in the regime and layout its plan must choose,
    three launches a forward and backward, two passes bitwise equal (one
    on a fresh host thread); timed beside ``torch.bmm``, the parent design (two launches on contiguous
    copies of the transposed operands) and those copies alone; K4 and K5
    at TM's layer (2 x 4096, 16 heads of 128, bf16) as in 10;
22. K8b (the SSD backward) against ``ssd_chunk_bwd_ref`` at paths TP's
    and TH's calls (1 x 4096, chunk 256; 80 heads of 64 with N 128, 112
    heads of 64 with N 64) in float32 (the CUDA-core kernel ``ssd_bwd.cu``,
    1e-5 relative L2) and with bf16 inputs (the tensor-core regime
    ``ssd_bwd_tc.cu``, 2e-2 as in 7, each of the five outputs' error
    printed), B and C one row shared by the heads read from NaN-filled
    allocations, each in the regime its plan must choose with the plan's
    shared memory the library's own count, two launches bitwise equal,
    packed B and C bitwise equal to shared ones in bf16, timed with its
    bound (bytes, or operations over the bf16 tensor-core peak) beside the
    CUDA-core kernel on the same bf16 inputs; a bf16 call the tensor-core
    regime refuses (P 32) on the CUDA-core kernel, and the tensor-core
    regime at two sequences with chunks of 128 and 64; K8 at the same calls;
    the scan's float32 gradient on a ragged tail (L 40, chunk 16, an
    initial state) through K8 and K8b against the plain versions (1e-5
    relative L2); K4 and K5 at TH's layer (1 x 4096, 32 heads of 112);
23. main paths TM, TP and TH, ``launch.train``'s driver at OLMoE-1B-7B's
    (1 of 16 layers), Mamba2-2.7B's (8 of 64) and Zamba2-7B's (6 of 81,
    one shared-attention site) full width in bf16 (the depths cut from 8,
    64 and 36 when paths ST and TT joined the run, and again from 4, 32
    and 18 when SQ, SM and TS did, to keep it within its time limit), 4
    steps of 4 x 4096
    tokens in the configs' own microbatches (2, 4, 4), 2 pods and the
    budget cut at step 1, the final checkpoint in a temporary directory
    that is removed: exact launch counts (a layer a microbatch: K7 3 + 3 +
    6 under remat, K4 twice and K5 once; K8 twice and K8b once; the
    hybrid's shared block K4 and K5 once a site), plans, caps and K1-K3
    launches equal to the same driver's CPU run at the smoke size, finite
    losses and gradient norms, one batch's loss and gradients through the
    kernels against the plain versions on the card in bf16 at the path's
    depth for TP and TH (1e-2 relative and 5e-2 relative L2), for TM one
    layer's backward at a microbatch's 2 x 4096 tokens run twice with
    equal bits; two warm steps timed and a third traced (the device's
    idle share); and OLMoE-1B-7B at full width and 4 layers in float32 on
    TM's shape (routing holds there), loss and gradients within 1e-4 of
    the plain versions;
24. every kernel entry point (K1, K2 and its occupancy query, K3, K4 and
    K5 in both regimes, K6, K7, K8 and K8b in both regimes) launched again
    from a new host thread whose first CUDA work it is, into NaN-filled
    outputs, bitwise equal to the same launch from the main thread; then
    K4, K5 and K6 against their plain versions in bf16 and float32 (two
    launches bitwise equal) at the new paths' shapes, timed beside the
    plain versions and SDPA with their bounds: I's prefill (8 x 768 rows,
    48/8 heads of 128, causal) and decode step (784 of 1,024 positions
    live), TI's microbatch (1 x 4096, K4 and K5), Y's encoder (8 x 1500
    frames, 6/6 heads of 64, non-causal: a ragged last key tile), its
    prefill's cross attention (4 rows over 1,500 keys) and its decode
    step's on K6 (kv_len 1,500), TY's encoder (32 x 1500) and cross
    attention (32 x 448 rows over 1,500 keys, K4 and K5);
25. main paths Y and I, serving: Y is Whisper-tiny whole in bf16 behind
    ``make_fleet``'s router (``launch.serve.main`` first, which raises for
    want of frames, as the reference's driver fails), each replica's 8
    requests through ``generate`` with 1,500 frames a request, prompts of
    4, 64 tokens, a 448-position cache, then ``power_event``'s cap event;
    I is ``launch.serve``'s driver at InternVL2-26B's full width and depth
    in bf16 (48 layers, 1.99e10 parameters; path S's arguments, text
    only, as the reference's driver serves it), then each replica's batch
    through ``generate`` again with a 256-patch prefix.  Exact launch
    counts (Y: K4 4 + 4 + 4 a prefill and 4 a decode step, which re-runs
    the encoder, K6 8 a decode step; I: K4 once a layer a prefill and K6
    once a layer a decode step, both runs), the cap event identical to
    its CPU run, one replica's batch fed back through the plain versions
    on the card (logits within 2e-2 relative L2), prefill and decode-step
    times; and each in float32 (Whisper-tiny whole, InternVL2-26B at 4
    layers) with identical greedy tokens and logits within 1e-4;
26. main paths TY and TI, training in bf16 under ``launch.train``'s power
    plane (2 pods, the budget cut at step 1; the model through
    ``make_train_step`` on batches with ``launch.inputs``' frontend
    stand-ins, since the training driver passes none): TY Whisper-tiny
    whole, 4 steps of 32 x 448 tokens over 1,500 frames; TI
    InternVL2-26B at 6 of 48 layers, 4 steps of 4 x 4096 rows (256
    patches, 3,840 tokens) in the config's 4 microbatches.  Exact launch
    counts (a microbatch, under remat: K4 twice and K5 once an attention,
    Y's encoder, self and cross attentions each), the plans and caps
    equal to the same events' CPU run, finite losses and gradient norms,
    one batch's loss and every gradient (``vision_proj`` too) against the
    plain versions on the card (1e-2 relative and 5e-2 relative L2; TY's
    at its initial parameters, and at its trained state, where training
    shuts its cross attention and leaves those gradients to the rounding
    of two forwards' bf16 O, K4 launch by launch against its plain
    forward and K5 against its plain version fed K4's O; float32 after
    the same 4 steps within 1e-4); two warm steps timed and a third
    traced (the device's idle share);
27. the device mesh, each path its own ranks started by
    ``launch.mesh.spawn`` (their backend and devices printed first, by
    the mesh's rule: gloo for two ranks sharing the card, nccl for one
    rank on it); gloo moves the ranks' CUDA tensors through host memory,
    so their collectives' times are not an interconnect's.  Path SC: path A's grid, path D's
    dynamic grid, ``row_contention_specs(sizes=(10,))`` through the pad
    buckets and A's first three specs under cpc (three cells: two ranks
    pad one copy) split over two ranks and run on one rank under nccl,
    every per-cell count, energy, payload, final placement, power state
    and cap bitwise equal to the same grids in this process on every
    rank, each bucket split over ``min(world, cells)`` ranks, each rank's
    K1 and K2 launches those of its shard of the cells run alone here (K1
    a tick and K2 a DRS invocation through the buckets), with K1 and K2
    held against their plain versions at a rank's shard (16 x 100 x 10);
    path ME: one OLMoE-1B-7B MoE layer at full width (64 experts top-8,
    d_ff 1024, its capacity factor) on 8 x 512 tokens, expert-parallel on
    a ``("data", "model") = (1, 2)`` mesh (32 experts a rank) against the
    dense dispatch on the whole weights on the card: float32 output within
    1e-6 and the gradients of x, the router and every expert leaf within
    1e-5 relative L2, bf16 within 2e-2 as in 7, K7 3 launches a forward
    and 6 a backward on each rank, with K7 at a rank's products against
    its plain version; path TE: MiniCPM-2B at full width and 4 layers in
    float32, data parallel on ``("pod", "data") = (2, 1)``, one batch's
    gradients within 1e-4 (loss 1e-5) of one rank's,
    ``compressed_cross_pod_mean`` of each pod's gradients equal on both
    ranks and to the plain mean of the dequantized values, then 3 steps,
    a resize 2 -> 1 (``dpm-poweroff``), 3 steps, a resize 1 -> 2
    (``dpm-poweron``) and 3 steps (``AdamW(learning_rate=1e-3)``, 4 x
    1024 tokens), every restored leaf, the moments and step too, bitwise
    the saved one and the data cursor saved with it, every loss within
    1e-5 of one unresized rank on the same batches, the reference
    example's assertions, K4 twice and K5 once a layer a step, with K4 and
    K5 at its layer in float32 against their plain versions; path ST:
    granite-8b at full width and 18 of 36 layers in bf16 served tensor
    parallel on
    ``("pod", "data", "model") = (1, 1, 2)`` (16 of 32 heads, 4 of 8 kv
    heads, half the ffn and vocabulary a rank; the prefill's rules equal
    to the decode's), 8 prompts of 512, 32 greedy tokens, a 1,024-position
    cache, against one rank of the same parameters: teacher-forced logits
    within 1e-2 relative L2, K4 18 and K6 18 x 31 launches a rank, a
    decode step's collectives timed, a rank's peak memory; at 4 layers in
    float32 tokens identical and logits within 1e-5; path TT: granite-8b
    at full width and 4 layers, 3 steps of 4 x 4096 tokens in bf16,
    tensor parallel on (1, 1, 2) and ZeRO-3 on (1, 2, 1), each against
    one rank: the first step's gradients within 4.9e-3 relative L2 a leaf
    or within 1.05 times one rank's distance from the float32 gradient,
    ZeRO-3's peak memory a rank below one rank's, K4 twice and K5 once a
    layer a microbatch; at 2 layers in float32 (4 x 1024 tokens; tensor
    parallel 2 steps, ZeRO-3 1) every gradient leaf and the losses within
    1e-5; with K4, K5 and K6 at both paths' local-head shapes against
    their plain versions, timed (device times too) beside SDPA; paths
    SQ and SM (one spawn of two ranks sharing the card) and TS (another),
    each under the production rules (``rules_for(configs.get(arch),
    SHAPES[...], mesh_size=256 or 512)`` at ``model_axis=16``) bound on
    the small mesh and against one rank of the same parameters: SQ serves
    MiniCPM-2B at full width (4 of 40 layers in bf16, 2 in float32; 20
    and 18 tokens: each decode step gathers its FSDP-stored layers through
    host memory, 7.6 s a step at full depth) and Granite-8B at 4 layers
    in float32 (32 tokens), 8 prompts of 512, the prefill under
    ``prefill_32k``'s rules (the sequence over ``model``; Granite's kv
    heads whole) and the decode steps under ``decode_32k``'s (the cache's
    positions over ``model``: a 1,056-position cache split at 528, rank
    1's block empty for 16 steps), the state carried by
    ``relayout_decode_state``, teacher forced on one rank's greedy tokens;
    SM serves Mamba2-2.7B whole in bf16 (40 of 80 heads a rank, 12
    tokens) and at 4 layers in float32 with S's other arguments for one
    replica, and Zamba2-7B at 6 of 81 layers (one shared-attention site)
    under ``long_500k``'s rules on ``(1, 2, 1)`` (the cache's positions
    over ``data``, no batch split): one 8,192-token prompt, 4 tokens in
    bf16 and 2 in float32, a 65,536-position cache whose rank-1 block
    stays empty; bf16 teacher-forced logits within 1e-2 (SQ) or 2e-2 (SM)
    relative L2 of one rank's or, where not, no farther from one rank's
    float32 logits than 1.05 times one rank's own distance from them;
    float32 argmaxes identical and logits within 1e-5; exact launches (K4
    a layer at prefill, K6 through its log-sum-exp entry a layer a decode
    step, K8 a Mamba2 layer); TS trains MiniCPM-2B at 2 of 40 layers
    (``seq`` and ``inner_seq``: K4 and K5 at ``q_offset`` 2048 on rank
    1), InternVL2-26B at 1 of 48 with its 256-patch prefix (Megatron-SP)
    and Mamba2-2.7B at 8 of 64 (its heads), 2 steps of 4 x 4096 under
    ``train_4k``'s rules at 512 chips, TT's gates (4.9e-3 or 1.05 times
    one rank's distance from float32) and float32 at 2 layers (InternVL2
    1; 4 x 1024, one microbatch, 2 steps) within 1e-5 in the losses and
    the gradients (Mamba2's ``a_log`` and ``dt_bias``, where past it,
    within 1.05 times one rank's distance from a float64 gradient written
    apart); with K6's log-sum-exp entry (rows with
    0, 1 and every position live: the output equal bit for bit to
    ``decode_attention``'s, the log-sum-exp within 1e-6 of the plain
    version's) and K4 and K5 at
    a query offset against their plain versions first.
28. phase DR and the roofline shares (CPU work in a worker process
    while the card runs the paths): the dry run (``launch/dryrun.py``) of
    one cell of each family (:data:`DR_CELLS`) on the 16 x 16 and
    2 x 16 x 16 meshes, rank 0's and the last rank's steps on their blocks
    under a fake process group of 256 or 512, each cell's dominant term
    and wall printed; and each timed step of paths S, M, P, H, I, Y, T,
    TM, TP, TH, TI and TY counted on ``meta`` stand-ins at the path's own
    shapes and depth (``launch/costing.py``), its kernel-path roofline
    bound on one H100 printed beside the measured warm step as a share.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Run from the repository root:
``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The dry run's roofline is the one place the bf16 and HBM3 peaks are
# defined.
from repro_torch.launch.dryrun import HBM_BW as PEAK_BYTES_S  # noqa: E402
from repro_torch.launch.dryrun import PEAK_FLOPS as PEAK_BF16_FLOPS  # noqa

#: H100 SXM peaks (NVIDIA data sheet) outside the tensor cores: fp64 and
#: float32.  K1-K3 are fp64 vector code.
PEAK_FP64_FLOPS = 34e12
PEAK_FP32_FLOPS = 67e12
REPS = 20
#: :func:`time_ms`'s repetitions where one call takes over ``SLOW_MS``
#: (the plain versions at the paths' shapes, up to 270 ms a call).
SLOW_REPS, SLOW_MS = 5, 20.0
RTOL = ATOL = 1e-9
F64 = torch.float64
#: The attention kernels' tolerances (the reference's own ``_tol``),
#: relative to the values' scale (:func:`attn_close`).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: Path S: the serving driver at granite-8b's full width and depth.
SERVE_ARGV = ["--arch", "granite_8b", "--replicas", "2", "--requests", "16",
              "--prompt-len", "512", "--decode-steps", "32",
              "--max-len", "1024"]
#: Path T: the training driver at MiniCPM-2B's full width and 10 of its 40
#: layers (its final checkpoint at full depth, 27 GB, took 43.5 s on an
#: H100 host); its power plane is held against the same events at the
#: smoke size on the CPU.
T_LAYERS = 10
TRAIN_EVENTS = ["--global-batch", "4", "--pods", "2", "--steps", "6",
                "--power-budget-drop-at", "1", "--straggler-at", "2",
                "--checkpoint-every", "0"]
TRAIN_ARGV = ["--arch", "minicpm_2b", "--seq-len", "4096"] + TRAIN_EVENTS
TRAIN_CPU_ARGV = ["--arch", "minicpm_2b", "--smoke", "--device", "cpu",
                  "--seq-len", "32"] + TRAIN_EVENTS


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn) -> float:
    """Median wall of ``fn`` on the card, by CUDA events, after a warm-up:
    of :data:`REPS` calls, or of :data:`SLOW_REPS` where the first timed
    call takes over :data:`SLOW_MS`."""
    fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < (SLOW_REPS if times and times[0] > SLOW_MS
                        else REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, pattern: str, reps: int = 6) -> float | None:
    """Mean device time (ms) of one launch of the kernel whose name holds
    ``pattern``, over the last ``reps`` of ``2 * reps`` calls of ``fn``
    under ``torch.profiler``, read from the trace's kernel events as
    ``tools/profile_sweep_torch.py`` reads them.  Each call launches it
    once.  The trace may miss the launches of a profile's first moments
    (for launches of about 0.03 ms, as many as eight of twelve), so the
    profile idles 0.2 s before the calls, and a trace with fewer than
    ``reps`` of them is taken again, three times at most; a trace that
    holds none although it holds kernel events fails (a wrong pattern).

    A process whose device activity the profiler cannot see (CUPTI held
    by another tracer) gets a trace with no kernel event at all.  When the
    tries find no kernel event, or never ``reps`` of this one, the device
    time is not measured: the result is None, and the run goes on on its
    CUDA-event times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.2)
            for _ in range(2 * reps):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            trace = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(trace))
            events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        durs = [e["dur"] for e in sorted(kernels, key=lambda e: e["ts"])
                if pattern in e["name"]]
        if kernels and not durs:
            raise AssertionError(f"{pattern}: no such kernel in a trace of "
                                 f"{len(kernels)} kernel events")
        if len(durs) > 2 * reps:
            raise AssertionError(f"{pattern}: {len(durs)} kernel events in "
                                 f"the trace of {2 * reps} calls")
        if len(durs) >= reps:
            return sum(durs[-reps:]) / reps * 1e-3
        seen = max(seen, len(durs))
    log(f"{pattern}: device time not measured (the profiler's traces held "
        f"at most {seen} of {2 * reps} launches in three tries)")
    return None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(n_bytes: float, flops: float,
             peak_flops: float = PEAK_FP64_FLOPS) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def bisection_trips(cap, fl, ce, w, act, iters: int) -> torch.Tensor:
    """The bisection trips each ``(..., J)`` row runs in the kernels' row
    routine (``csrc/waterfill.cuh``: none on a degenerate row, else up to
    the first whose midpoint meets an end of the bracket), found in the
    plain version's arithmetic: the work the kernels' bounds count."""
    from repro_torch.core.kernels import clip

    fl = torch.where(act, fl, 0.0)
    ce = torch.maximum(torch.where(act, ce, 0.0), fl)
    w = torch.where(act, w, 1e-12)
    target = torch.minimum(cap, ce.sum(-1))
    hi = (ce / w).amax(-1) + 1.0
    lo = torch.zeros_like(hi)
    running = fl.sum(-1) < cap
    trips = torch.zeros(hi.shape, dtype=torch.int64, device=hi.device)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        under = clip(w * mid[..., None], fl, ce).sum(-1) < target
        collapsed = (mid == lo) | (mid == hi)
        lo = torch.where(running & under, mid, lo)
        hi = torch.where(running & ~under, mid, hi)
        trips += running
        running &= ~collapsed
    return trips


def kernel_inputs(S: int, H: int, J: int, seed: int, dev, iters: int):
    """Random cells with both host types, some hosts off, some cells (never
    the first) with the policy disabled, reservations, limits, hot hosts,
    and poisoned (large, stale) values in the inactive slots; ``iters``
    bisection trips for K2's waterfills."""
    from repro_torch.core import kernels as ck

    rng = np.random.RandomState(seed)
    small = rng.rand(S, H) < 0.5
    idle = np.where(small, 120.0, 160.0)
    peak = np.where(small, 240.0, 320.0)
    cpk = np.where(small, 19_200.0, 34_800.0)
    hyp = np.where(rng.rand(S, H) < 0.3, rng.uniform(0, 400, (S, H)), 0.0)
    on = rng.rand(S, H) < 0.95
    caps = np.where(on, rng.uniform(idle + 5, peak - 5), 0.0)
    budget = (caps * on).sum(-1)
    active = (rng.rand(S, H, J) < 0.9) & on[..., None]
    res = np.where(rng.rand(S, H, J) < 0.3, rng.uniform(0, 300, (S, H, J)),
                   0.0)
    hot = 1.0 + 2.0 * (rng.rand(S, H, 1) < 0.2)
    dem = rng.uniform(200, 3000, (S, H, J)) * hot
    limit = np.where(rng.rand(S, H, J) < 0.1,
                     rng.uniform(1000, 3000, (S, H, J)), np.inf)
    weights = rng.choice([1000.0, 2000.0], (S, H, J))
    poison = rng.uniform(1e6, 1e9, (S, H, J))
    floors = np.where(active, np.minimum(res, limit), poison)
    ceils = np.where(active, np.clip(dem, res, limit), poison)
    t = {k: torch.as_tensor(v, dtype=F64, device=dev) for k, v in dict(
        idle=idle, peak=peak, cpk=cpk, hyp=hyp, caps=caps, budget=budget,
        floors=floors, ceils=ceils, weights=weights,
        cpu_res=(res * active).sum(-1),
        dem=np.where(active, np.minimum(dem, limit), poison),
        dfl=np.where(active, np.minimum(res, np.minimum(dem, limit)),
                     poison)).items()}
    hosts = ck.HostCols(torch.as_tensor(on, device=dev), t["idle"],
                        t["peak"], t["cpk"], t["hyp"])
    act = torch.as_tensor(active, device=dev)
    enabled = rng.rand(S) < 0.9
    enabled[0] = True
    enabled = torch.as_tensor(enabled, device=dev)
    return dict(
        hosts=hosts, caps=t["caps"], budget=t["budget"], enabled=enabled,
        cpu_res=t["cpu_res"],
        dense=ck.DenseCols(t["floors"], t["ceils"], t["weights"], act,
                           iters),
        wf=(ck.managed_capacity(hosts, t["caps"]), t["dfl"], t["dem"],
            t["weights"], act))


def k3_inputs(case: str, dev, seed: int = 11, m_path: int = 1000):
    """``(capacity, floors, ceilings, weights, seg_ids, n_segs)`` for K3.

    ``path``: the main path's shape, ``m_path`` hosts x 10 VMs placed round
    robin (so the CSR permutation is not the identity), demand 200-3000
    MHz, some reservations, capacity of a host capped near 250 W.
    ``ragged``: 300 hosts with 0-24 items each, some empty, one of 256
    items, one whose floors exceed its capacity, and every other host's
    items 1e6-1e9 MHz, so that each row borders huge values.
    """
    rng = np.random.RandomState(seed)
    if case == "path":
        m, n = m_path, 10 * m_path
        seg = np.arange(n) % m
        counts = np.bincount(seg, minlength=m)
    else:
        m = 300
        counts = rng.randint(0, 25, m)
        counts[rng.rand(m) < 0.1] = 0
        counts[7] = 256
        counts[8] = 5
        seg = rng.permutation(np.repeat(np.arange(m), counts))
        n = seg.size
    res = np.where(rng.rand(n) < 0.3, rng.uniform(0, 300, n), 0.0)
    dem = rng.uniform(200, 3000, n)
    floors = np.minimum(res, dem)
    weights = rng.choice([1000.0, 2000.0], n)
    cap = rng.uniform(0.4, 1.1, m) * np.maximum(
        np.bincount(seg, weights=dem, minlength=m), 1.0)
    if case == "ragged":
        floors[seg == 8] = 500.0
        dem[seg == 8] = 800.0
        cap[8] = 1000.0
        odd = seg % 2 == 1
        big = rng.uniform(1e6, 1e9, n)
        floors = np.where(odd, 0.1 * big, floors)
        dem = np.where(odd, big, dem)
        cap = np.where(np.arange(m) % 2 == 1, 3e9, cap)
    t = [torch.as_tensor(x, dtype=F64, device=dev)
         for x in (cap, floors, dem, weights)]
    return (*t, seg, m)


def k3_cost(cap, fl, ce, w, lay, iters: int) -> tuple:
    """K3's and its plain version's CUDA-event times on these inputs and
    K3's bound: ``(ms, plain_ms, bound_ms, bound_by, trips)``."""
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import to_rows

    m, n = lay.n_segs, fl.numel()
    ms = time_ms(lambda: ops.waterfill_segmented(cap, fl, ce, w, iters=iters,
                                                 layout=lay))
    pms = time_ms(lambda: ref.waterfill_segmented_ref(cap, fl, ce, w, lay,
                                                      iters))
    active = (torch.arange(lay.jb, device=fl.device) < lay.counts[:, None])
    trips = bisection_trips(cap, to_rows(lay, fl), to_rows(lay, ce),
                            to_rows(lay, w, fill=1e-12), active, iters)
    bound, by = bound_ms(8 * m + 16 * m + 8 * n + 3 * 8 * n + 8 * n,
                         float(((4 * trips + 12) * lay.counts).sum()))
    return ms, pms, bound, by, trips


def k3_record(m: int, n: int, **fields) -> dict:
    return dict(name=f"waterfill_segmented {m}x{n}", route="cuda",
                source="src/repro_torch/kernels/powercap/csrc/segmented.cu",
                replaces="src/repro/kernels/powercap/kernel.py:181",
                library_ms=None, **fields)


def check_k3(dev, m_path: int = 1000, tag: str = "V") -> dict:
    """K3 against its plain version: the path's shape (``m_path`` hosts,
    timed, with its bound) and the ragged case."""
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import segment_layout

    errs = {}
    for case in ("ragged", "path"):
        cap, fl, ce, w, seg, m = k3_inputs(case, dev, m_path=m_path)
        lay = segment_layout(seg, m, dev)
        got = ops.waterfill_segmented(cap, fl, ce, w, layout=lay)
        want = ref.waterfill_segmented_ref(cap, fl, ce, w, lay, 200)
        torch.cuda.synchronize()
        errs[case] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K3 {case}: kernel and plain version "
                                 f"differ (max abs err {errs[case]})")
        if not torch.isfinite(got).all():
            raise AssertionError(f"K3 {case}: non-finite allocation")
    ms, pms, bound, by, trips = k3_cost(cap, fl, ce, w, lay, 200)
    log(f"{tag}: K3 err {errs['path']:.3e} (ragged {errs['ragged']:.3e}) "
        f"{ms:.4f} ms (plain {pms:.3f} ms), rows of {lay.jb} slots")
    return k3_record(m, fl.numel(), max_abs_err=errs["path"],
                     ragged_max_abs_err=errs["ragged"], rtol=RTOL,
                     atol=ATOL, ms=ms, plain_ms=pms, bound_ms=bound,
                     bound_by=by, mean_trips=float(trips.double().mean()))


def balance_plan(S: int, H: int, J: int) -> dict:
    """K2's plan for the shape, with the card's occupancy answers and the
    limit they set."""
    from repro_torch.kernels.powercap import kernel

    clusters = kernel.max_active_clusters(J)
    return dict(dataclasses.asdict(kernel.balance_plan(S, H, J, clusters)),
                max_active_clusters=list(clusters),
                limit_hosts=kernel.balance_limit(clusters))


def check_kernels(shapes, dev, plan_cells=None) -> dict:
    """K2 (and K1, where ``shapes`` flags it) against their plain versions
    at each ``(S, H, J, with_k1, iters)``: K1 runs 100 bisection trips, as
    the batched engine's delivery does; K2 runs ``iters``, with round
    counts and ``did`` flags equal to the plain version's, its plan sized
    for ``plan_cells`` cells (``None``: S), as a shard of a larger grid
    sizes it."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import kernel, ops, ref

    params = ck.BalanceParams()
    out = {}
    for tag, (S, H, J, with_k1, iters) in shapes.items():
        x = kernel_inputs(S, H, J, seed=S * 7919 + H, dev=dev, iters=iters)
        n = S * H * J
        out[tag] = []
        if with_k1:
            cap, fl, ce, w, act = x["wf"]
            k1 = ops.waterfill_dense(cap, fl, ce, w, 100, active=act)
            p1 = ref.waterfill_dense_ref(cap, fl, ce, w, 100, act)
            torch.cuda.synchronize()
            err1 = float((k1 - p1).abs().max())
            if not torch.allclose(k1, p1, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"K1 {tag}: kernel and plain version "
                                     f"differ (max abs err {err1})")
            ms1 = time_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, 100,
                                                      active=act))
            pms1 = time_ms(lambda: ref.waterfill_dense_ref(cap, fl, ce, w,
                                                           100, act))
            dms1 = device_ms(lambda: ops.waterfill_dense(
                cap, fl, ce, w, 100, active=act), "waterfill_kernel")
            trips1 = bisection_trips(cap, fl, ce, w, act, 100)
            b1, by1 = bound_ms(8 * S * H + 3 * 8 * n + n + 8 * n,
                               float((4 * trips1 + 12).sum()) * J)
            g, k = kernel.row_shape(J)
            log(f"{tag}: K1 err {err1:.3e} {ms1:.4f} ms, device "
                f"{fmt_ms(dms1)} (plain {pms1:.3f} ms), {g} lanes a row")
            out[tag].append(dict(
                name=f"waterfill_dense {S}x{H}x{J}", route="cuda",
                source="src/repro_torch/kernels/powercap/csrc/waterfill.cu",
                replaces="src/repro/kernels/powercap/kernel.py:48",
                max_abs_err=err1, rtol=RTOL, atol=ATOL, ms=ms1,
                device_ms=dms1, plain_ms=pms1, bound_ms=b1, bound_by=by1,
                library_ms=None, row_lanes=g, row_slots_a_lane=k,
                mean_trips=float(trips1.double().mean())))

        out[tag].append(check_k2(tag, (
            x["hosts"], x["caps"], x["dense"], x["cpu_res"], x["budget"],
            x["enabled"], params), plan_cells=plan_cells))
    return out


def check_k2(tag: str, args: tuple, bitwise: bool = False,
             plan_cells=None, **extra) -> dict:
    """K2 against its plain version on ``args`` (``balance_caps``'), timed
    beside it by CUDA events and the profiler, with its bound: caps within
    ``RTOL`` (no absolute slack), or bitwise where ``bitwise``, round
    counts and ``did`` flags equal.  ``plan_cells`` as
    ``balance_caps`` takes it."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import ops, ref

    hosts, caps, dense = args[:3]
    S, H, J = dense.floors.shape
    n, iters = S * H * J, dense.iters
    kc, kd, kr = ops.balance_caps(*args, plan_cells=plan_cells)
    pc, pd, pr = ref.balance_caps_ref(*args)
    torch.cuda.synchronize()
    err2 = float((kc - pc).abs().max())
    if not (torch.equal(kc, pc) if bitwise
            else torch.allclose(kc, pc, rtol=RTOL, atol=0.0)):
        raise AssertionError(f"K2 {tag}: caps differ (max abs err "
                             f"{err2})")
    if not torch.equal(kd, pd):
        raise AssertionError(f"K2 {tag}: did flags differ")
    if not torch.equal(kr, pr):
        raise AssertionError(f"K2 {tag}: rounds {kr.tolist()[:16]} on "
                             f"the card, {pr.tolist()[:16]} in the "
                             f"plain version")
    plan = balance_plan(plan_cells or S, H, J)
    ms2 = time_ms(lambda: ops.balance_caps(*args, plan_cells=plan_cells))
    dms2 = device_ms(lambda: ops.balance_caps(*args, plan_cells=plan_cells),
                     "balance_caps_kernel")
    pms2 = time_ms(lambda: ref.balance_caps_ref(*args))
    # Each round's waterfills run about as many trips as the first
    # (at the input caps) does.
    trips2 = float(bisection_trips(
        ck.managed_capacity(hosts, caps), dense.floors,
        dense.ceils, dense.weights, dense.active,
        iters).double().mean())
    waterfills = float((1 + pr.double()).sum()) * H
    b2, by2 = bound_ms((1 + 4 * 8 + 8 + 8 + 8) * S * H + 25 * n + 9 * S
                       + 5 * S, waterfills * (4 * trips2 + 12) * J
                       + float(pr.double().sum()) * 40 * H)
    log(f"{tag}: K2 err {err2:.3e} rounds {pr.tolist()[:16]} (equal) "
        f"{ms2:.4f} ms, device {fmt_ms(dms2)} (plain {pms2:.3f} ms), "
        f"plan {json.dumps(plan)}")
    return dict(
        name=f"balance_caps {S}x{H}x{J}", route="cuda",
        source="src/repro_torch/kernels/powercap/csrc/balance.cu",
        replaces="src/repro/kernels/powercap/kernel.py:109", **extra,
        max_abs_err=err2, bitwise=bool(torch.equal(kc, pc)),
        rtol=0.0 if bitwise else RTOL, atol=0.0, ms=ms2, device_ms=dms2, plain_ms=pms2, bound_ms=b2,
        bound_by=by2, library_ms=None, rounds_equal_plain=True,
        rounds=int(pr.sum()), mean_trips=trips2,
        cluster=plan["cluster"], plan=plan)


def check_row_shapes(dev) -> dict:
    """K1 and K2 at rows of 3, 40, 100 and 300 slots (the row routine's
    4-lane, two-slot, four-slot and streamed shapes) and K3 at rows of 300
    and 1,000 items, each against its plain version at 1e-9 (K2 with equal
    rounds and ``did`` flags); returns the largest errors."""
    from repro_torch.core.kernels import BalanceParams
    from repro_torch.kernels.powercap import ops, ref
    from repro_torch.kernels.powercap.segments import segment_layout

    errs = {"K1": {}, "K2": {}, "K3": {}}
    for J in (3, 40, 100, 300):
        x = kernel_inputs(3, 70, J, seed=J, dev=dev, iters=100)
        cap, fl, ce, w, act = x["wf"]
        got = ops.waterfill_dense(cap, fl, ce, w, 100, active=act)
        want = ref.waterfill_dense_ref(cap, fl, ce, w, 100, act)
        torch.cuda.synchronize()
        errs["K1"][J] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K1 J {J}: max abs err {errs['K1'][J]}")
        args = (x["hosts"], x["caps"], x["dense"], x["cpu_res"], x["budget"],
                x["enabled"], BalanceParams())
        (kc, kd, kr), (pc, pd, pr) = (ops.balance_caps(*args),
                                      ref.balance_caps_ref(*args))
        errs["K2"][J] = float((kc - pc).abs().max())
        if not (torch.allclose(kc, pc, rtol=RTOL, atol=0.0)
                and torch.equal(kd, pd) and torch.equal(kr, pr)):
            raise AssertionError(f"K2 J {J}: max abs err {errs['K2'][J]}, "
                                 f"rounds {kr.tolist()} / {pr.tolist()}")
    rng = np.random.RandomState(17)
    for width in (300, 1000):
        counts = np.array([width, 3, 0, width // 2 + 1, 7])
        seg = rng.permutation(np.repeat(np.arange(counts.size), counts))
        n = seg.size
        dem = rng.uniform(200, 3000, n)
        fl = np.where(rng.rand(n) < 0.3, rng.uniform(0, 150, n), 0.0)
        cap = rng.uniform(0.3, 1.2, counts.size) * np.maximum(
            np.bincount(seg, weights=dem, minlength=counts.size), 1.0)
        t = [torch.as_tensor(a, dtype=F64, device=dev)
             for a in (cap, fl, dem, rng.choice([1000.0, 2000.0], n))]
        lay = segment_layout(seg, counts.size, dev)
        got = ops.waterfill_segmented(*t, layout=lay)
        want = ref.waterfill_segmented_ref(*t, lay, 200)
        torch.cuda.synchronize()
        errs["K3"][width] = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
            raise AssertionError(f"K3 rows of {width}: max abs err "
                                 f"{errs['K3'][width]}")
    log(f"row shapes: {json.dumps(errs)}")
    return errs


def compare(tag, gpu, cpu, keys, rtol: float = RTOL) -> None:
    """Exact cap-change, vMotion and power-event counts, ``rtol`` (1e-9)
    on payload and energy."""
    for spec_name, policy in keys:
        g, c = gpu[spec_name][policy], cpu[spec_name][policy]
        for f in ("cap_changes", "vmotions", "power_ons", "power_offs"):
            if getattr(g, f) != getattr(c, f):
                raise AssertionError(
                    f"{tag} {spec_name}/{policy}: {f} {getattr(g, f)} on "
                    f"the card, {getattr(c, f)} in the comparison run")
        for f in ("cpu_payload_mhz_s", "energy_j"):
            a, b = getattr(g, f), getattr(c, f)
            if not abs(a - b) <= rtol * abs(b):
                raise AssertionError(f"{tag} {spec_name}/{policy} {f}: "
                                     f"{a!r} vs {b!r}")
        if not np.isfinite(g.cpu_payload_mhz_s) or g.cpu_payload_mhz_s <= 0:
            raise AssertionError(f"{tag} {spec_name}/{policy}: no payload")


KERNELS = ("waterfill_dense", "balance_caps", "waterfill_segmented")


def _model_wrappers() -> dict:
    """The model kernels' wrappers (K4, K5, K6, K7, K8, K8b) by name."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.flash_attention,
            "flash_attention_bwd": fa_ops.flash_attention_bwd,
            "decode_attention": da_ops.decode_attention,
            "grouped_matmul": gmm_ops.grouped_matmul,
            "ssd_scan": ssd_ops.ssd_scan,
            "ssd_scan_bwd": ssd_ops.ssd_chunk_bwd}


def reset_launches() -> None:
    from repro_torch.kernels.powercap import ops
    for name in KERNELS:
        getattr(ops, name).launches = 0
    for fn in _model_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    """Every wrapper's count: K1-K3, then the model kernels."""
    from repro_torch.kernels.powercap import ops
    return dict({name: getattr(ops, name).launches for name in KERNELS},
                **{n: fn.launches for n, fn in _model_wrappers().items()})


def no_model_launches() -> dict:
    """The model kernels' counts on a path that runs no model."""
    return dict.fromkeys(_model_wrappers(), 0)


def build_all() -> float:
    """Build the five kernel libraries at once (every ``nvcc`` process
    started together) and load them; returns the wall seconds."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.powercap import kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel

    t0 = time.perf_counter()
    libs = (fa_kernel.LIBRARY, da_kernel.LIBRARY, gmm_kernel.LIBRARY,
            ssd_kernel.LIBRARY)
    builds = (kernel.build,) + tuple(lib.build for lib in libs)
    with ThreadPoolExecutor(len(builds)) as pool:
        logs = [f.result()[1] for f in [pool.submit(b) for b in builds]]
    print("\n".join(logs), file=sys.stderr, flush=True)
    kernel.library()
    for lib in libs:
        lib.library()
    return time.perf_counter() - t0


def randn(shape, dtype, dev, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def attn_close(got, want, tol: float, what: str) -> float:
    """Max abs error of ``got`` against ``want``, raising past ``tol``
    relative to the values' scale: ``rtol = tol`` and ``atol = tol`` times
    the RMS of ``want`` where that is under 1 (attention outputs and
    gradients over thousands of keys are far smaller than 1, so an
    absolute ``tol`` would pass a wrong kernel); returns the error.  The
    kernel records give ``tol`` as ``rtol`` and ``atol_per_rms``."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = tol * min(1.0, float(want.square().mean().sqrt()))
    if not (torch.allclose(got, want, rtol=tol, atol=atol)
            and torch.isfinite(got).all()):
        raise AssertionError(f"{what}: kernel and reference differ (max abs "
                             f"err {err}, rtol {tol}, atol {atol:.3e})")
    return err


def attn_err(got, want, dtype, what: str) -> float:
    """:func:`attn_close` at the dtype's tolerance."""
    return attn_close(got, want, ATTN_TOL[dtype], what)


#: bf16 cases of K4's and K5's tensor-core regimes (phases 7 and 10):
#: ``(B, Sq, Skv, Hq, Hkv, D, causal, q_offset)``.  "view_nan" reads k and
#: v as views into caches whose positions past Skv and whose features past
#: D in each head hold NaN.
ATTN_BF16_CASES = {
    "ragged": (2, 100, 164, 8, 2, 128, True, 64),
    "view_nan": (2, 100, 164, 8, 2, 128, True, 64),
    "mqa": (2, 256, 256, 8, 1, 64, True, 0),
    "full": (2, 192, 192, 4, 2, 112, False, 0),
}


def attn_operands(b, sq, skv, hq, hkv, d, dtype, dev, seed: int,
                  view: bool = False):
    """q, k, v and dO from ``seed``; with ``view``, k and v are views into
    NaN-filled caches of 36 more positions and 8 more features a head."""
    q = randn((b, sq, hq, d), dtype, dev, seed)
    k = randn((b, skv, hkv, d), dtype, dev, seed + 1)
    v = randn((b, skv, hkv, d), dtype, dev, seed + 2)
    do = randn((b, sq, hq, d), dtype, dev, seed + 3)
    if view:
        def poisoned(t):
            big = torch.full((b, skv + 36, hkv, d + 8), float("nan"),
                             dtype=dtype, device=dev)
            big[:, :skv, :, :d] = t
            return big[:, :skv, :, :d]
        k, v = poisoned(k), poisoned(v)
    return q, k, v, do


def attn_plan(q, k, v, dout=None, want: str | None = None, what: str = ""):
    """The plan that K4's wrapper (K5's, given ``dout``) makes for the
    call; with ``want``, raises unless it names that regime and, on the
    tensor cores, its shared memory equals the library's own count."""
    from repro_torch.kernels.flash_attention import kernel, kernel_bwd
    b, sq, hq, d = q.shape
    ts = (q, k, v) if dout is None else (q, k, v, dout)
    p = (kernel.plan if dout is None else kernel_bwd.plan)(
        b, sq, k.shape[1], hq, k.shape[2], d, q.dtype,
        tuple(kernel.bshd_strides(t) for t in ts),
        all(t.data_ptr() % 16 == 0 for t in ts))
    if want is not None:
        lib = (kernel.smem_bytes("fwd", d) if dout is None else
               (kernel.smem_bytes("dkdv", d), kernel.smem_bytes("dq", d)))
        if p.regime != want or (want == "tensor_core"
                                and p.smem_bytes != lib):
            raise AssertionError(f"{what}: plan {p}, expected {want} "
                                 f"(library shared memory {lib})")
    return p


def k4_case(q, k, v, causal, q_offset, what: str) -> float:
    """K4 against its plain version (out and lse), two launches bitwise
    equal; returns the larger error."""
    from repro_torch.kernels.flash_attention import ops, ref
    out, lse = ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    pout, plse = ref.flash_attention_ref(q, k, v, causal=causal,
                                         q_offset=q_offset,
                                         block_k=ops.BLOCK_K)
    err = max(attn_err(out, pout, q.dtype, what),
              attn_err(lse, plse, q.dtype, f"{what} lse"))
    again, again_lse = ops.flash_attention(q, k, v, causal=causal,
                                           q_offset=q_offset)
    if not (torch.equal(out, again) and torch.equal(lse, again_lse)):
        raise AssertionError(f"{what}: two launches differ")
    return err


def check_k4(dev) -> dict:
    """K4 against its plain version: a float32 case with a query offset
    and ragged lengths (the CUDA-core kernel), the bf16 cases of
    ``ATTN_BF16_CASES`` and path S's prefill shape in bf16 (the tensor
    cores), each in the regime its plan must choose, the bf16 ones two
    launches bitwise equal; path S's timed, with its bound and SDPA's time
    on the same inputs."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    f32 = torch.float32
    q = randn((2, 100, 32, 128), f32, dev, 1)
    k, v = randn((2, 164, 8, 128), f32, dev, 2), randn((2, 164, 8, 128),
                                                       f32, dev, 3)
    attn_plan(q, k, v, want="cuda_core", what="K4 float32")
    out, lse = ops.flash_attention(q, k, v, causal=True, q_offset=64)
    pout, plse = ref.flash_attention_ref(q, k, v, causal=True, q_offset=64,
                                         block_k=ops.BLOCK_K)
    err32 = attn_err(out, pout, f32, "K4 float32, q_offset 64")
    attn_err(lse, plse, f32, "K4 float32 lse")

    bf = torch.bfloat16
    cases = {}
    for i, (case, (b, sq, skv, hq, hkv, d, causal, qoff)) in enumerate(
            ATTN_BF16_CASES.items()):
        q, k, v, _ = attn_operands(b, sq, skv, hq, hkv, d, bf, dev,
                                   100 + 4 * i, view=case == "view_nan")
        attn_plan(q, k, v, want="tensor_core", what=f"K4 {case}")
        cases[case] = k4_case(q, k, v, causal, qoff, f"K4 bf16 {case}")
    log(f"K4 tensor-core cases (errors, two launches bitwise equal): "
        f"{json.dumps(cases)}")

    b, s, hq, hkv, d = 8, 512, 32, 8, 128
    q = randn((b, s, hq, d), bf, dev, 4)
    k, v = randn((b, s, hkv, d), bf, dev, 5), randn((b, s, hkv, d), bf,
                                                    dev, 6)
    p = attn_plan(q, k, v, want="tensor_core", what="K4 path S")
    err = k4_case(q, k, v, True, 0, "K4 bf16, path S prefill")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_ms(lambda: ops.flash_attention(q, k, v))
    pms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                  block_k=ops.BLOCK_K))
    lms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = s * (s + 1) // 2
    bound, by = bound_ms(2 * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                         + 4 * b * hq * s, 4 * b * hq * d * pairs,
                         PEAK_BF16_FLOPS)
    log(f"S: K4 ({p.regime}) err {err:.3e} (float32 {err32:.3e}) {ms:.4f} "
        f"ms (plain {pms:.3f} ms, SDPA {lms:.4f} ms, bound {bound:.4f} ms)")
    return dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
                source="src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_fwd_tc.cu",
                replaces="src/repro/kernels/flash_attention/kernel.py:83",
                regime=p.regime, max_abs_err=err, float32_max_abs_err=err32,
                case_errs=cases, rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf],
                ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
                library_ms=lms)


def k6_plan(q, k, v, what: str):
    """The plan that K6's wrapper makes for the call, its shared memory
    held against the library's own count."""
    from repro_torch.kernels.decode_attention import kernel
    b, hq, d = q.shape
    p = kernel.plan(b, k.shape[1], hq, k.shape[2], d, q.dtype,
                    (k.stride()[:2], v.stride()[:2]),
                    k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    lib = kernel.library_smem_bytes(d, q.dtype, p.lanes, p.rows)
    if lib != p.smem_bytes:
        raise AssertionError(f"{what}: plan {p}, library shared memory "
                             f"{lib}")
    return p


def k6_case(q, k, v, kv_len, what: str, block_k: int | None = None):
    """K6 against its plain version (the reference's blocks of ``block_k``
    positions, 512 by default), two launches bitwise equal; returns the
    error and the plan."""
    from repro_torch.kernels.decode_attention import ops, ref
    p = k6_plan(q, k, v, what)
    out = ops.decode_attention(q, k, v, kv_len)
    err = attn_err(out, ref.decode_attention_split_ref(
        q, k, v, kv_len, block_k or ops.BLOCK_K), q.dtype, what)
    if not torch.equal(out, ops.decode_attention(q, k, v, kv_len)):
        raise AssertionError(f"{what}: two launches differ")
    return err, p


def time_k6(q, k, v, kv_len) -> dict:
    """K6 beside its plain version and ``scaled_dot_product_attention``
    (masked to each row's live prefix) on the same inputs, with its bound:
    the live K and V bytes, or ``4 Hq D`` operations a live position."""
    from repro_torch.kernels.decode_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    hq, d = q.shape[1:]
    s, hkv = k.shape[1], k.shape[2]
    mask = (torch.arange(s, device=q.device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, kv_len))
    pms = time_ms(lambda: ref.decode_attention_split_ref(q, k, v, kv_len,
                                                         ops.BLOCK_K))
    lms = time_ms(lambda: sdpa(q4, kt, vt, attn_mask=mask,
                               enable_gqa=hq != hkv))
    live = float(kv_len.double().sum())
    bound, by = bound_ms(2 * 2 * live * hkv * d, 4 * live * hq * d,
                         PEAK_BF16_FLOPS)
    return dict(ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
                bound_by=by)


def k6_record(shape, err, err32, p, times, **extra) -> dict:
    b, s, hq, d = shape
    bf = torch.bfloat16
    return dict(name=f"decode_attention {b}x{s}x{hq}x{d}", route="cuda",
                source="src/repro_torch/kernels/decode_attention/csrc/"
                       "decode.cu",
                replaces="src/repro/kernels/decode_attention/kernel.py:55",
                plan=dict(split=p.split, lanes=p.lanes, rows=p.rows,
                          grid=list(p.grid), vector_loads=p.vector_loads),
                max_abs_err=err, float32_max_abs_err=err32,
                rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf], **times,
                **extra)


def check_k6(dev) -> dict:
    """K6 against its plain version over a 1024-position cache with
    ragged lengths, in float32 and bf16 (two launches bitwise equal, the
    plan's shared memory the library's; timed, with SDPA on the same
    inputs), and a case with every split but the first fully masked."""
    b, s, hq, hkv, d = 8, 1024, 32, 8, 128
    g = torch.Generator(device=dev).manual_seed(7)
    kv_len = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((b, hq, d), dtype, dev, 8)
        k, v = randn((b, s, hkv, d), dtype, dev, 9), randn((b, s, hkv, d),
                                                           dtype, dev, 10)
        errs[dtype], p = k6_case(q, k, v, kv_len, f"K6 {dtype}")
    mq = randn((2, 2, 32), torch.float32, dev, 11)
    mk = randn((2, 512, 2, 32), torch.float32, dev, 12)
    mlen = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    masked, mp = k6_case(mq, mk, mk, mlen, "K6 fully masked splits", 64)
    if mp.splits < 2 or mp.split < 3:    # kv_len 1 and 3: one live split
        raise AssertionError(f"K6 fully masked splits: plan {mp}")
    # A cache whose positions lie 8 * 128 + 4 elements apart (8 bytes past
    # a 16-byte multiple in bf16): the element copies instead of cp.async.
    wide = randn((b, s, hkv * d + 4), torch.bfloat16, dev, 13)
    uk = wide.as_strided((b, s, hkv, d), (s * (hkv * d + 4), hkv * d + 4,
                                          d, 1))
    uq = randn((b, hq, d), torch.bfloat16, dev, 14)
    unaligned, up = k6_case(uq, uk, uk, kv_len, "K6 unaligned pitch")
    if up.vector_loads:
        raise AssertionError(f"K6 unaligned pitch: plan {up}")
    times = time_k6(q, k, v, kv_len)
    err = errs[torch.bfloat16]
    log(f"S: K6 (split {p.split}, lanes {p.lanes}, rows {p.rows}) err "
        f"{err:.3e} (float32 {errs[torch.float32]:.3e}, masked "
        f"{masked:.3e}, unaligned pitch {unaligned:.3e}) "
        f"{times['ms']:.4f} ms (plain {times['plain_ms']:.3f} "
        f"ms, SDPA {times['library_ms']:.4f} ms, bound "
        f"{times['bound_ms']:.5f} ms); reruns bitwise equal; kv_len "
        f"{kv_len.tolist()}")
    return k6_record((b, s, hq, d), err, errs[torch.float32], p, times,
                     masked_max_abs_err=masked,
                     unaligned_max_abs_err=unaligned)


def check_m_attention(dev) -> list:
    """K4 and K6 at path M's shapes (OLMoE-1B-7B's 16/16 heads of 128,
    bf16): K4 on the prefill of 8 x 512 (the tensor cores), K6 over a
    1024-position cache with ragged lengths, each against its plain
    version (K6's reruns bitwise equal), timed beside its plain version
    and SDPA, with its bound.  Returns their records for path M."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    bf = torch.bfloat16
    b, s, h, d, cache = 8, 512, 16, 128, 1024
    q, k, v, _ = attn_operands(b, s, s, h, h, d, bf, dev, 90)
    p4 = attn_plan(q, k, v, want="tensor_core", what="K4 path M")
    err4 = k4_case(q, k, v, True, 0, "K4 bf16, path M prefill")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms4 = time_ms(lambda: ops.flash_attention(q, k, v))
    pms4 = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                   block_k=ops.BLOCK_K))
    lms4 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    bound4, by4 = bound_ms(2 * 4 * b * s * h * d + 4 * b * h * s,
                           4 * b * h * d * (s * (s + 1) // 2),
                           PEAK_BF16_FLOPS)
    g = torch.Generator(device=dev).manual_seed(91)
    kv_len = torch.randint(1, cache + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    dq = randn((b, h, d), bf, dev, 92)
    dk, dv = (randn((b, cache, h, d), bf, dev, 93 + i) for i in range(2))
    err6, p6 = k6_case(dq, dk, dv, kv_len, "K6 bf16, path M")
    times6 = time_k6(dq, dk, dv, kv_len)
    log(f"M: K4 ({p4.regime}) err {err4:.3e} {ms4:.4f} ms (plain "
        f"{pms4:.3f} ms, SDPA {lms4:.4f} ms, bound {bound4:.4f} ms); K6 "
        f"(split {p6.split}) err {err6:.3e} {times6['ms']:.4f} ms (plain "
        f"{times6['plain_ms']:.3f} ms, SDPA {times6['library_ms']:.4f} ms, "
        f"bound {times6['bound_ms']:.5f} ms)")
    return [dict(name=f"flash_attention {b}x{s}x{h}x{d}", route="cuda",
                 source="src/repro_torch/kernels/flash_attention/csrc/"
                        "flash_fwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:83",
                 regime=p4.regime, max_abs_err=err4, rtol=ATTN_TOL[bf],
                 atol_per_rms=ATTN_TOL[bf], ms=ms4, plain_ms=pms4,
                 bound_ms=bound4, bound_by=by4, library_ms=lms4),
            k6_record((b, cache, h, d), err6, None, p6, times6)]


#: K5's cases: ``(B, Sq, Skv, Hq, Hkv, D, causal, q_offset, dtype)``;
#: "path" is path T's layer, the one timed; the bf16 cases of
#: ``ATTN_BF16_CASES`` join them.
K5_CASES = {
    "path": (4, 4096, 4096, 36, 36, 64, True, 0, torch.bfloat16),
    "gqa": (8, 512, 512, 32, 8, 128, True, 0, torch.bfloat16),
    "mqa": (2, 100, 164, 8, 1, 32, True, 64, torch.float32),
    "full": (2, 192, 192, 4, 2, 16, False, 0, torch.float32),
    **{f"{case}_bf16": shape + (torch.bfloat16,)
       for case, shape in ATTN_BF16_CASES.items()},
}
#: K5's tolerances (``tests/test_kernels_bwd.py``'s 1e-4 in float32; the
#: reference's bfloat16 tolerance), relative to the values' scale
#: (:func:`attn_close`).
K5_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def k5_case(q, k, v, do, causal, q_offset, what: str, bitwise: bool):
    """K5 against its plain version from K4's forward; with ``bitwise``,
    two launches must give the same bits.  Returns ``(errors by output,
    (q, k, v, out, lse, do), K5's outputs)``."""
    from repro_torch.kernels.flash_attention import ops, ref
    with torch.no_grad():
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset)
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                  q_offset=q_offset)
    want = ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=causal, q_offset=q_offset,
        block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K)
    tol = K5_TOL[q.dtype]
    errs = {name: attn_close(a, w, tol, f"{what} {name}")
            for name, a, w in zip(("dq", "dk", "dv"), got, want)}
    if bitwise:
        again = ops.flash_attention_bwd(q, k, v, out, lse, do,
                                        causal=causal, q_offset=q_offset)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"{what}: two launches differ")
    return errs, (q, k, v, out, lse, do), got


def check_k5(dev) -> list:
    """K5 against its plain version in every case of ``K5_CASES`` (and, in
    the float32 MQA case, against autograd of ``attention_ref``), each in
    the regime its plan must choose (the tensor cores for bf16, the CUDA
    cores for float32), the bf16 ones two launches bitwise equal; the
    path's case timed beside the plain version and SDPA's backward on the
    same inputs, and K4 timed at the same shape.  Returns the records of
    K4 and K5 at path T's layer."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    errs, regimes = {}, {}
    for case, (b, sq, skv, hq, hkv, d, causal, qoff, dtype) in \
            K5_CASES.items():
        q, k, v, do = attn_operands(b, sq, skv, hq, hkv, d, dtype, dev,
                                    20 + 4 * len(errs),
                                    view=case.startswith("view"))
        want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        regimes[case] = attn_plan(q, k, v, do, want, f"K5 {case}").regime
        errs[case], operands, got = k5_case(
            q, k, v, do, causal, qoff, f"K5 {case}",
            bitwise=want == "tensor_core")
        if case == "mqa":
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o = ref.attention_ref(qq, kk, vv, causal=causal, q_offset=qoff)
            oracle = torch.autograd.grad(o, (qq, kk, vv), do)
            for name, a, w in zip(("dq", "dk", "dv"), got, oracle):
                errs[case][f"oracle_{name}"] = attn_close(
                    a, w, K5_TOL[dtype], f"K5 {case} {name} against "
                    f"autograd of attention_ref")
        if case == "path":
            timed = operands

    b, s, hq, hkv, d, _, _, dtype = (K5_CASES["path"][i]
                                     for i in (0, 1, 3, 4, 5, 6, 7, 8))
    q, k, v, out, lse, do = timed
    k4_regime = attn_plan(q, k, v, want="tensor_core",
                          what="K4 at path T's layer").regime
    k4_err = attn_err(out, ref.flash_attention_ref(
        q, k, v, block_k=ops.BLOCK_K)[0], dtype, "K4 at path T's layer")
    ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, do))
    pms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    both_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot))
    pairs = s * (s + 1) // 2
    el = 2 if dtype == torch.bfloat16 else 4
    bound, by = bound_ms(el * (4 * b * s * hq * d + 4 * b * s * hkv * d)
                         + 4 * b * hq * s, 10 * b * hq * d * pairs,
                         PEAK_BF16_FLOPS)
    log(f"T: K5 regimes {json.dumps(regimes)} errs {json.dumps(errs)} "
        f"{ms:.3f} ms (plain {pms:.3f} ms, SDPA backward "
        f"{both_ms - fwd_ms:.3f} ms = {both_ms:.3f} - {fwd_ms:.3f}, bound "
        f"{bound:.4f} ms, {by})")
    k4_ms = time_ms(lambda: ops.flash_attention(q, k, v))
    k4_pms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                     block_k=ops.BLOCK_K))
    k4_bound, k4_by = bound_ms(el * (2 * b * s * hq * d + 2 * b * s * hkv * d)
                               + 4 * b * hq * s, 4 * b * hq * d * pairs,
                               PEAK_BF16_FLOPS)
    log(f"T: K4 ({k4_regime}) at the same shape err {k4_err:.3e} "
        f"{k4_ms:.3f} ms (plain {k4_pms:.3f} ms, SDPA {fwd_ms:.3f} ms, "
        f"bound {k4_bound:.4f} ms)")
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    k4 = dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
              source=src + "flash_fwd_tc.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:83",
              regime=k4_regime, max_abs_err=k4_err, rtol=ATTN_TOL[dtype],
              atol_per_rms=ATTN_TOL[dtype], ms=k4_ms, plain_ms=k4_pms,
              bound_ms=k4_bound, bound_by=k4_by, library_ms=fwd_ms)
    k5 = dict(name=f"flash_attention_bwd {b}x{s}x{hq}x{d}", route="cuda",
              source=src + "flash_bwd_tc.cu",
              replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
              regime=regimes["path"], case_regimes=regimes,
              max_abs_err=max(errs["path"].values()), case_errs=errs,
              rtol=K5_TOL[dtype], atol_per_rms=K5_TOL[dtype], ms=ms,
              plain_ms=pms, bound_ms=bound, bound_by=by,
              library_ms=both_ms - fwd_ms,
              library_fwd_bwd_ms=both_ms, library_fwd_ms=fwd_ms)
    return [k4, k5]


def plain_k4(q, k, v, causal, q_offset):
    """K4's plain version, as ``ops._forward`` is called."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    return fa_ref.flash_attention_ref(q, k, v, causal=causal,
                                      q_offset=q_offset,
                                      block_k=fa_ops.BLOCK_K)


def plain_k5(q, k, v, out, lse, dout, *, causal, q_offset):
    """K5's plain version, as ``ops.flash_attention_bwd`` is called."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    return fa_ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout, causal=causal, q_offset=q_offset,
        block_q=fa_ops.BLOCK_Q, block_k=fa_ops.BLOCK_K)


@contextlib.contextmanager
def plain_attention():
    """The model's attention through the plain versions of K4, K5 and K6,
    on whatever device the tensors are (the comparison runs only).  The
    one ``ops.FlashAttention`` Function serves both runs: its forward and
    backward callees are swapped for the plain versions."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention import ref as da_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import layers

    def decode(q, k, v, kv_len):
        return da_ref.decode_attention_split_ref(q, k, v, kv_len,
                                                 da_ops.BLOCK_K)

    with mock.patch.object(fa_ops, "_forward", plain_k4), \
            mock.patch.object(fa_ops, "flash_attention_bwd", plain_k5), \
            mock.patch.object(layers, "decode_attention", decode):
        yield


@contextlib.contextmanager
def plain_k5_given_k4(errs: list, tag: str):
    """K4 on the card, each launch's O and log-sum-exp held against the
    plain forward on the same inputs (``attn_err``; the larger error of
    each launch appended to ``errs``), and K5 swapped for its plain
    version fed K4's O and lse.  K4 launches are bitwise repeatable, so a
    run in here has the kernels' forward, and its gradients differ from
    the kernels' by K5's arithmetic alone, not by the bf16 rounding of two
    forwards' O (the comparison runs only)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    k4 = fa_ops._forward

    def forward(q, k, v, causal, q_offset):
        out, lse = k4(q, k, v, causal, q_offset)
        pout, plse = plain_k4(q, k, v, causal, q_offset)
        what = f"{tag}: K4 at {tuple(q.shape)} x {k.shape[1]} keys"
        errs.append(max(attn_err(out, pout, q.dtype, what),
                        attn_err(lse, plse, q.dtype, f"{what}, lse")))
        return out, lse

    with mock.patch.object(fa_ops, "_forward", forward), \
            mock.patch.object(fa_ops, "flash_attention_bwd", plain_k5):
        yield


@contextlib.contextmanager
def count_plain_calls():
    """Counts the outermost calls of K1-K3's plain versions in a CPU run,
    yielding the counts: each is one launch on the card.  A plain version
    called inside another (K2's loop runs K1's plain waterfill each round)
    is part of the outer kernel's launch and not counted."""
    from repro_torch.kernels.powercap import ref
    counts, depth = dict.fromkeys(KERNELS, 0), [0]

    def counting(name, fn):
        def call(*args, **kwargs):
            if depth[0] == 0:
                counts[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return call

    with contextlib.ExitStack() as stack:
        for name in KERNELS:
            stack.enter_context(mock.patch.object(
                ref, f"{name}_ref", counting(name, getattr(ref,
                                                           f"{name}_ref"))))
        yield counts


def rel_l2(got, want) -> float:
    return float((got.double() - want.double()).norm()
                 / want.double().norm())


def run_serving_path(dev) -> tuple[dict, dict]:
    """Path S through ``launch.serve.main`` on the card, with the launch
    counts of exactly that run; its cap event held against the CPU, one
    replica's batch against the plain versions; then warm timings."""
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_loop import generate

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SERVE_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    # K1-K3 as the same cap event's CPU run calls their plain versions
    # (K2 once, K3 twice for the note, K1 for the migration balancer's
    # entitlements and the round that finds nothing to move).
    power_launches = hold_cap_event("S", report, 16, n_rep)
    want = {"flash_attention": cfg.n_layers * n_rep,
            "flash_attention_bwd": 0,
            "decode_attention": cfg.n_layers * (steps - 1) * n_rep,
            "grouped_matmul": 0, "ssd_scan": 0, "ssd_scan_bwd": 0,
            **power_launches}
    if launches != want:
        raise AssertionError(f"S: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"S: routing {report.routing}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"S {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"S {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]
    with plain_attention():
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    err = rel_l2(logits, plain_logits)
    if not err <= 2e-2:
        raise AssertionError(f"S: teacher-forced logits {err:.3e} relative "
                             f"L2 from the plain versions (bound 2e-2)")
    same = float((plain_logits.argmax(-1) == toks).float().mean())

    prefill_ms, step_ms = warm_serve_ms(cfg, params, prompts, None, steps,
                                        max_len, 3)
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    cache_gb = (2 * cfg.n_layers * 8 * max_len * cfg.n_kv_heads
                * cfg.head_dim * params["blocks"]["wk"].element_size()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=prefill_ms,
                decode_step_ms=step_ms,
                weights_gb=weights_gb, cache_gb_per_batch=cache_gb,
                peak_memory_gb=peak_gb, teacher_forced_rel_l2=err,
                plain_argmax_equal=same, routing=report.routing,
                routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count())
    info["decode_graph"] = check_decode_graph("S", cfg, params, prompts,
                                              None, steps, max_len)
    log(f"path S: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, cache {cache_gb:.3f} GB a batch, peak "
        f"{peak_gb:.3f} GB; teacher-forced logits {err:.3e} relative L2 "
        f"(argmax equal {same:.3f}); launches {launches}; cap event "
        f"{report.caps_after} W, {report.routing_after}, {report.notes}")
    return launches, info


def run_f32_depth_check(dev) -> dict:
    """granite-8b at full width, 4 layers, float32: kernels against plain
    versions, greedily, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get("granite_8b"), n_layers=4,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention():
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks):
        raise AssertionError("S f32: greedy tokens differ between the "
                             "kernels and the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"S f32: logits {err:.3e} relative L2 from the "
                             f"plain versions (bound 1e-4)")
    log(f"S f32, 4 layers: tokens identical, logits {err:.3e} relative L2")
    return dict(rel_l2=err, tokens_identical=True)


def rel_l2_sliced(got, want) -> float:
    """``rel_l2`` a slice of 2**24 elements at a time, for leaves whose
    float64 copies would not fit beside the training state."""
    num = den = 0.0
    for a, b in zip(got.reshape(-1).split(1 << 24),
                    want.reshape(-1).split(1 << 24)):
        a, b = a.float(), b.float()
        num += float((a - b).square().sum(dtype=torch.float64))
        den += float(b.square().sum(dtype=torch.float64))
    return (num / den) ** 0.5 if den > 0 else float(num > 0) * float("inf")


def _grads_against_plain(grads_fn, params, batch, loss_rtol, grad_rtol,
                         tag, plain=None) -> tuple[float, float]:
    """The loss and every gradient of one batch through the kernels and
    through the plain versions on the card (``plain``, a context manager:
    ``plain_kernels()`` when not given); returns (loss relative error,
    worst leaf's relative L2), raising past the bounds."""
    from repro_torch.tree import leaves_with_path

    grads, metrics = grads_fn(params, batch)
    with plain_kernels() if plain is None else plain:
        pgrads, pmetrics = grads_fn(params, batch)
    loss_err = abs(float(metrics["loss"]) - float(pmetrics["loss"])) / abs(
        float(pmetrics["loss"]))
    if not loss_err <= loss_rtol:
        raise AssertionError(f"{tag}: loss {float(metrics['loss'])} vs "
                             f"{float(pmetrics['loss'])} with the plain "
                             f"versions (bound {loss_rtol})")
    worst, worst_path = 0.0, None
    for (path, g), (_, pg) in zip(leaves_with_path(grads),
                                  leaves_with_path(pgrads)):
        err = rel_l2_sliced(g, pg)
        if not torch.isfinite(g).all() or not err <= grad_rtol:
            raise AssertionError(f"{tag}: gradient {'/'.join(path)} {err:.3e}"
                                 f" relative L2 from the plain versions "
                                 f"(bound {grad_rtol})")
        if err >= worst:
            worst, worst_path = err, "/".join(path)
    log(f"{tag}: loss {loss_err:.3e} relative from the plain versions, "
        f"worst gradient {worst_path} {worst:.3e} relative L2")
    return loss_err, worst


def run_training_path(dev) -> tuple[dict, dict]:
    """Path T through ``launch.train.main`` on the card, with the launch
    counts of exactly that run; its power plane held against the CPU, one
    step's loss and gradients against the plain versions; then warm
    timings."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.models import transformer as tfm
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import make_grads_fn, make_train_step

    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with depth_cut(T_LAYERS):
            report = train.main(TRAIN_ARGV + ["--checkpoint-dir", ckpt_dir])
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        reserved_gb = torch.cuda.max_memory_reserved() / 1e9
        ckpt_bytes = os.path.getsize(report.checkpoint_path)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, state = report.cfg, report.state
    steps = len(report.losses)
    # The power plane's K1-K3 launches are those of the same events on the
    # CPU (the plan does not depend on the model).
    cpu_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with count_plain_calls() as power_launches:
            cpu = train.main(TRAIN_CPU_ARGV + ["--checkpoint-dir", cpu_dir])
    finally:
        shutil.rmtree(cpu_dir, ignore_errors=True)
    want = dict(power_launches, flash_attention=2 * cfg.n_layers * steps,
                flash_attention_bwd=cfg.n_layers * steps,
                decode_attention=0, grouped_matmul=0, ssd_scan=0,
                ssd_scan_bwd=0)
    if steps != 6 or launches != want:
        raise AssertionError(f"T: {steps} steps, kernel launches {launches}, "
                             f"expected {want}")
    if (report.plans, report.caps) != (cpu.plans, cpu.caps):
        raise AssertionError(f"T: power plane on the card {report.plans} "
                             f"{report.caps}, on the CPU {cpu.plans} "
                             f"{cpu.caps}")
    if not (np.isfinite(report.losses).all()
            and np.isfinite(report.grad_norms).all()):
        raise AssertionError(f"T: losses {report.losses}, grad norms "
                             f"{report.grad_norms}")

    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4096,
                           global_batch=4, seed=1, device=dev)
    b = data.next_batch()
    batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    grads_fn = make_grads_fn(cfg)
    loss_err, grad_err = _grads_against_plain(
        grads_fn, state.params, batch, 1e-2, 5e-2, "T bf16")

    # Warm timings: a whole step (forward, backward, AdamW; it updates the
    # state's tensors in place), AdamW alone, and one layer's forward and
    # backward.
    opt = AdamW(learning_rate=3e-4, state_dtype=cfg.optimizer_state_dtype)
    step = make_train_step(cfg, opt)
    step_ms = [_event_ms(lambda: step(state, batch)) for _ in range(2)]
    grads, _ = grads_fn(state.params, batch)
    adamw_ms = statistics.median(
        _event_ms(lambda: opt.update(grads, state.opt_state, state.params))
        for _ in range(3))
    del grads
    blk = {name: w[0].detach().requires_grad_()
           for name, w in state.params["blocks"].items()}
    h = randn((4, 4096, cfg.d_model), torch.bfloat16, dev, 5
              ).requires_grad_()
    dh = randn((4, 4096, cfg.d_model), torch.bfloat16, dev, 6)
    positions = torch.arange(4096, device=dev)[None, :]
    leaves_in = [h] + list(blk.values())

    def layer():
        out, _, _ = tfm._attn_block(blk, h, cfg, positions, None)
        torch.autograd.grad(out, leaves_in, dh)
    layer_ms = time_ms(layer)
    # Trained tokens carry weight 1 in the plan; the pods' masked examples
    # are processed on the shared card but train nothing.
    processed = 4 * 4096 * steps
    trained = float(sum(report.tokens))
    info = dict(wall_s=wall, steps_s=report.seconds,
                trained_tokens=trained,
                tokens_per_s=trained / report.seconds,
                tokens_processed=processed,
                processed_tokens_per_s=processed / report.seconds,
                warm_step_ms=statistics.median(step_ms),
                layer_fwd_bwd_ms=layer_ms, adamw_ms=adamw_ms,
                peak_memory_gb=peak_gb, peak_reserved_gb=reserved_gb,
                checkpoint_s=report.checkpoint_s,
                checkpoint_bytes=ckpt_bytes, losses=report.losses,
                grad_norms=report.grad_norms, plans=report.plans,
                caps=report.caps, loss_rel_err_plain=loss_err,
                worst_grad_rel_l2_plain=grad_err, params=cfg.param_count(),
                launches_power_plane=power_launches)
    log(f"path T: {steps} steps of 4 x 4096 tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} trained tokens/s, "
        f"{info['processed_tokens_per_s']:.1f} processed; whole driver "
        f"{wall:.3f} s, "
        f"checkpoint {report.checkpoint_s:.2f} s for {ckpt_bytes} bytes); "
        f"warm step {info['warm_step_ms']:.1f} ms, one layer forward and "
        f"backward {layer_ms:.2f} ms, AdamW {adamw_ms:.2f} ms; peak "
        f"{peak_gb:.3f} GB ({reserved_gb:.3f} GB reserved); losses "
        f"{report.losses}; grad norms {report.grad_norms}; plans "
        f"{report.plans}; caps {report.caps}; launches {launches}")
    return launches, info


def _event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def run_train_f32_check(dev) -> dict:
    """MiniCPM-2B at full width, 4 layers, float32: two steps through the
    kernels and through the plain versions from one initial state, loss
    and every gradient within 1e-4 relative each step."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW, global_norm
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn

    cfg = dataclasses.replace(configs.get("minicpm_2b"), n_layers=4,
                              param_dtype="float32")
    opt = AdamW(learning_rate=1e-3)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=1024,
                           global_batch=2, seed=2, device=dev)
    grads_fn = make_grads_fn(cfg)
    errs = []
    for i in range(2):
        b = data.next_batch()
        batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
        errs.append(_grads_against_plain(grads_fn, state.params, batch, 1e-4,
                                         1e-4, f"T f32, 4 layers, step {i}"))
        grads, _ = grads_fn(state.params, batch)
        opt.update(grads, state.opt_state, state.params,
                   grad_norm=global_norm(grads))
    return dict(loss_rel_err=[e[0] for e in errs],
                worst_grad_rel_l2=[e[1] for e in errs])


#: K7's cases, ``(E, C, D, F, dtype)``: path M's three products (its
#: prefill's gate and up products, its down product, a decode step's gate
#: and up products), DeepSeekMoE's ragged d_ff of 1408 with a ragged C in
#: float32, C = 1, a D that is no multiple of K7's depth tiles, the regime
#: boundary at path M's D and F (C = 64 the narrow regime's widest N, C =
#: 72 the wide regime with 56 dead rows), a bf16 shape whose pitches TMA
#: cannot read (the CUDA-core kernel), and two views into larger
#: allocations whose rows past C and columns past D and F hold NaN (any
#: read past an edge shows), one a regime.
K7_CASES = {
    "prefill": (64, 640, 2048, 1024, torch.bfloat16),
    "prefill_down": (64, 640, 1024, 2048, torch.bfloat16),
    "decode": (64, 8, 2048, 1024, torch.bfloat16),
    "ragged_f32": (64, 650, 2048, 1408, torch.float32),
    "c1_f32": (5, 1, 1000, 136, torch.float32),
    "ragged_d_bf16": (8, 100, 1000, 200, torch.bfloat16),
    "c64_bf16": (64, 64, 2048, 1024, torch.bfloat16),
    "c72_bf16": (64, 72, 2048, 1024, torch.bfloat16),
    "pitch_bf16": (4, 33, 1001, 77, torch.bfloat16),
    "poisoned_wide": (8, 200, 1000, 1000, torch.bfloat16),
    "poisoned_narrow": (8, 5, 1000, 1000, torch.bfloat16),
}
#: The regime each case must take (``kernel.plan``).
K7_REGIMES = {"prefill": "wide", "prefill_down": "wide", "decode": "narrow",
              "ragged_f32": "cuda_core", "c1_f32": "cuda_core",
              "ragged_d_bf16": "wide", "c64_bf16": "narrow",
              "c72_bf16": "wide", "pitch_bf16": "cuda_core",
              "poisoned_wide": "wide", "poisoned_narrow": "narrow"}
#: Path M: the serving driver at OLMoE-1B-7B's full width and depth, with
#: path S's replicas, requests, prompts, tokens and cache.
MOE_ARGV = ["--arch", "olmoe_1b_7b"] + SERVE_ARGV[2:]


def k7_operands(case: str, i: int, dev):
    """x (a standard normal) and w (one scaled by 1/sqrt(D), as the model's
    weights are drawn) of ``K7_CASES[case]``; a poisoned case's are views
    into NaN-filled allocations with 56 more rows and 24 more columns."""
    e, c, d, f, dtype = K7_CASES[case]
    x = randn((e, c, d), dtype, dev, 20 + i)
    w = (randn((e, d, f), torch.float32, dev, 40 + i) * d ** -0.5).to(dtype)
    if case.startswith("poisoned"):
        big_x = torch.full((e, c + 56, d + 24), float("nan"), dtype=dtype,
                           device=dev)
        big_w = torch.full((e, d + 56, f + 24), float("nan"), dtype=dtype,
                           device=dev)
        big_x[:, :c, :d] = x
        big_w[:, :d, :f] = w
        x, w = big_x[:, :c, :d], big_w[:, :d, :f]
    return x, w


def check_k7(dev) -> dict:
    """K7 against its plain version in every case of ``K7_CASES`` (the
    attention kernels' tolerances, relative to the values' scale), in the
    regime ``K7_REGIMES`` names (the plan's shared memory equal to the
    library's own count), two launches bitwise equal, each timed beside its
    plain version and ``torch.bmm`` on the same operands.  Returns K7's
    record at path M's prefill product, with every case under ``cases``."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref

    cases = {}
    for i, (case, (e, c, d, f, dtype)) in enumerate(K7_CASES.items()):
        x, w = k7_operands(case, i, dev)
        p = kernel.plan(e, c, d, f, dtype, (x.stride(), w.stride()))
        if p.regime != K7_REGIMES[case] or (
                p.regime != "cuda_core"
                and kernel.smem_bytes(p.regime, c) != p.smem_bytes):
            raise AssertionError(f"K7 {case}: plan {p}, library shared "
                                 f"memory {kernel.smem_bytes(p.regime, c)}")
        got = ops.grouped_matmul(x, w)
        err = attn_err(got, ref.grouped_matmul_ref(x, w), dtype,
                       f"K7 {case} {e}x{c}x{d}x{f} {dtype} ({p.regime})")
        if not torch.equal(got, ops.grouped_matmul(x, w)):
            raise AssertionError(f"K7 {case}: two launches differ")
        ms = time_ms(lambda: ops.grouped_matmul(x, w))
        pms = time_ms(lambda: ref.grouped_matmul_ref(x, w))
        lms = time_ms(lambda: torch.bmm(x, w))
        bound, by = bound_ms(
            x.element_size() * (e * c * d + e * d * f + e * c * f),
            2.0 * e * c * d * f,
            PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS)
        cases[case] = dict(shape=[e, c, d, f], dtype=str(dtype)[6:],
                           regime=p.regime, n=p.n, max_abs_err=err, ms=ms,
                           plain_ms=pms, library_ms=lms, bound_ms=bound,
                           bound_by=by)
        log(f"M: K7 {case} {e}x{c}x{d}x{f} {str(dtype)[6:]} {p.regime}"
            f"{f' n{p.n}' if p.n else ''} err {err:.3e} {ms:.4f} ms (plain "
            f"{pms:.3f} ms, bmm {lms:.4f} ms, bound {bound:.4f} ms by {by}); "
            f"rerun bitwise equal")
    main = cases["prefill"]
    bf = torch.bfloat16
    return dict(name="grouped_matmul 64x640x2048x1024", route="cuda",
                source="src/repro_torch/kernels/moe_gmm/csrc/gmm_tc.cu",
                replaces="src/repro/kernels/moe_gmm/kernel.py:46",
                max_abs_err=max(cases[k]["max_abs_err"] for k in
                                ("prefill", "prefill_down", "decode")),
                float32_max_abs_err=cases["ragged_f32"]["max_abs_err"],
                rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf],
                ms=main["ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=main["library_ms"], cases=cases)


@contextlib.contextmanager
def plain_experts():
    """The MoE layer's expert products through K7's plain version (the
    comparison runs only)."""
    from repro_torch.kernels.moe_gmm import ref
    from repro_torch.models import moe

    with mock.patch.object(moe, "grouped_matmul", ref.grouped_matmul_ref):
        yield


@contextlib.contextmanager
def record_routes():
    """Yields a list that gains, for every MoE layer call, its top-k
    expert ids with each token's set sorted."""
    from repro_torch.models import moe

    seen, route = [], moe._route

    def recording(params, xt, cfg):
        gates, ids, aux = route(params, xt, cfg)
        seen.append(torch.sort(ids, dim=-1).values)
        return gates, ids, aux

    # A replayed decode step runs no Python: record every call eagerly.
    with mock.patch.object(moe, "_route", recording), eager_decode():
        yield seen


def flip_share(a: list, b: list) -> float:
    """The share of (token, layer) top-k sets that differ between two
    recorded runs of the same calls."""
    if len(a) != len(b) or any(x.shape != y.shape for x, y in zip(a, b)):
        raise AssertionError("the two runs made different MoE calls")
    differ = sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    return differ / sum(x.shape[0] for x in a)


class _FirstLayer(Exception):
    """Stops a forward at its first MoE layer (:func:`first_moe_input`)."""


def first_moe_input(cfg, params, prompts, max_len):
    """``(block weights, input)`` of the first layer's MoE in the prefill
    of ``prompts``; the forward stops there."""
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import make_prefill_step

    seen = []

    def capture(blk, x, cfg_):
        seen.append((blk, x))
        raise _FirstLayer

    with mock.patch.object(moe, "moe_ffn", capture):
        try:
            make_prefill_step(cfg, max_len)(params, prompts)
        except _FirstLayer:
            pass
    return seen[0]


def run_moe_serving_path(dev) -> tuple[dict, dict]:
    """Path M through ``launch.serve.main`` on the card, with the launch
    counts of exactly that run (K1-K3 counted as the same cap event's CPU
    run calls their plain versions); its cap event held against the CPU;
    the first layer's MoE on the path's prefill through K7 and its plain
    version; one replica's batch fed back through the plain versions of
    K4, K6 and K7 on the card (logits within 5e-2 relative L2, the
    reference's bar for MoE in bfloat16, where routing near ties flips),
    with the share of top-k sets that differ; then warm timings."""
    from repro_torch.launch import serve
    from repro_torch.models import moe
    from repro_torch.runtime.serve_loop import generate

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(MOE_ARGV)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    power_launches = hold_cap_event("M", report, 16, n_rep)
    want = dict(power_launches, flash_attention=cfg.n_layers * n_rep,
                flash_attention_bwd=0,
                decode_attention=cfg.n_layers * (steps - 1) * n_rep,
                grouped_matmul=3 * cfg.n_layers * steps * n_rep, ssd_scan=0,
                ssd_scan_bwd=0)
    if cfg.family != "moe" or launches != want:
        raise AssertionError(f"M: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"M: routing {report.routing}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"M {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"M {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]

    # One layer: routing is the same by construction (it precedes K7).
    blk, x = first_moe_input(cfg, params, prompts, max_len)
    out, _ = moe.moe_ffn(blk, x, cfg)
    with plain_experts():
        pout, _ = moe.moe_ffn(blk, x, cfg)
    gate_err = attn_close(out, pout, 2e-2, "M: the first layer's MoE at "
                                           "prefill, K7 against plain")
    del blk, x, out, pout

    with record_routes() as k_routes:
        _, k_logits = generate(cfg, params, prompts, steps, max_len,
                               forced=toks)
    with plain_attention(), plain_experts(), record_routes() as p_routes:
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    rerun_equal = bool(torch.equal(k_logits, logits))
    flips = flip_share(k_routes, p_routes)
    err = rel_l2(logits, plain_logits)
    if not err <= 5e-2:
        raise AssertionError(f"M: teacher-forced logits {err:.3e} relative "
                             f"L2 from the plain versions (bound 5e-2); "
                             f"top-k sets differing {flips:.4f}")
    same = float((plain_logits.argmax(-1) == toks).float().mean())
    del k_routes, p_routes, k_logits, plain_logits

    prefill_ms, step_ms = warm_serve_ms(cfg, params, prompts, None, steps,
                                        max_len, 3)
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=prefill_ms,
                decode_step_ms=step_ms,
                weights_gb=weights_gb, peak_memory_gb=peak_gb,
                first_layer_moe_max_abs_err=gate_err,
                teacher_forced_rel_l2=err, topk_sets_differing=flips,
                plain_argmax_equal=same,
                kernel_rerun_bitwise_equal=rerun_equal,
                routing=report.routing, routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count(),
                capacity_prefill=moe.expert_capacity(8 * prompt_len, cfg),
                capacity_decode=moe.expert_capacity(8, cfg))
    info["decode_graph"] = check_decode_graph("M", cfg, params, prompts,
                                              None, steps, max_len)
    log(f"path M: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, peak {peak_gb:.3f} GB; first layer's MoE "
        f"{gate_err:.3e} from plain; teacher-forced logits {err:.3e} "
        f"relative L2, top-k sets differing {flips:.5f}, argmax equal "
        f"{same:.3f}, kernel rerun bitwise equal {rerun_equal}; launches "
        f"{launches}; cap event {report.caps_after} W, "
        f"{report.routing_after}, {report.notes}")
    return launches, info


def run_moe_f32_check(dev) -> dict:
    """DeepSeekMoE-16B at full width, 4 layers, float32 (shared experts,
    top-6, K7 at F = 1408): greedy tokens and every layer's routing
    identical through the kernels and through the plain versions, logits
    within 1e-4 relative L2, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get("deepseek_moe_16b"), n_layers=4,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    with record_routes() as k_routes:
        toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention(), plain_experts(), record_routes() as p_routes:
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    flips = flip_share(k_routes, p_routes)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks) or flips != 0.0:
        raise AssertionError(f"M f32: greedy tokens equal "
                             f"{torch.equal(toks, ptoks)}, top-k sets "
                             f"differing {flips}, between the kernels and "
                             f"the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"M f32: logits {err:.3e} relative L2 from the "
                             f"plain versions (bound 1e-4)")
    log(f"M f32, DeepSeekMoE-16B 4 layers: tokens and routing identical, "
        f"logits {err:.3e} relative L2")
    return dict(rel_l2=err, tokens_identical=True, routing_identical=True)


#: Paths P and H: the serving driver at Mamba2-2.7B's and Zamba2-7B's full
#: width and depth, with path S's replicas, requests, prompts, tokens and
#: cache.
SSM_ARGV = {"P": ["--arch", "mamba2_2p7b"] + SERVE_ARGV[2:],
            "H": ["--arch", "zamba2_7b"] + SERVE_ARGV[2:]}
#: K8's tolerance, relative to the values' scale (:func:`attn_close`): the
#: kernel and its plain version both sum in float32, in other orders.
K8_TOL = 1e-4
#: K8's cases at the paths' prefill: ``(B, L, H, P, N, Q)``, bf16 inputs.
K8_CASES = {"P": (8, 512, 80, 64, 128, 256), "H": (8, 512, 112, 64, 64, 256)}


def ssd_inputs(b, l, h, p, n, dtype, dev, seed: int):
    """x, dt (softplus of a normal), a_log (the model's ``log(linspace(1,
    16, H))``) and B, C rows expanded over the heads (a head stride of 0,
    as the model hands them to K8), ``dtype`` but a_log float32."""
    x = randn((b, l, h, p), dtype, dev, seed)
    dt = torch.nn.functional.softplus(randn((b, l, h), torch.float32, dev,
                                            seed + 1)).to(dtype)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    bm = randn((b, l, 1, n), dtype, dev, seed + 2).expand(b, l, h, n)
    cm = randn((b, l, 1, n), dtype, dev, seed + 3).expand(b, l, h, n)
    return x, dt, a_log, bm, cm


def k8_bound(b, l, h, p, n, q, el) -> tuple[float, str]:
    """K8's least time: x, B and C read once (B and C one row shared by
    the heads), the log decay and dt in float32, y_intra, contrib and
    total written in float32; the causal operations of the two products
    and the state's outer product, over the bf16 or float32 peak."""
    nc = l // q
    n_bytes = (el * (b * l * h * p + 2 * b * l * n) + 2 * 4 * b * l * h
               + 4 * (b * l * h * p + b * nc * h * p * n + b * nc * h))
    flops = b * nc * h * (q * (q + 1) * (n + p) + 2 * q * p * n)
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS if el == 2
                    else PEAK_FP32_FLOPS)


def check_k8(dev) -> dict:
    """K8 against its plain version: at paths P's and H's prefill call in
    bf16 (B and C shared across the heads, as the model passes them; the
    tensor-core regime, as the plan must choose, with the library's shared
    memory; two launches bitwise equal; each timed beside the plain
    version), the same call with B and C packed (bitwise equal to the
    shared view), and a float32 scan with a ragged
    tail and an initial state through ``ops.ssd_scan`` against the
    sequential oracle ``ssd_ref`` (L 40, chunk 16, as in
    ``tests/test_kernels.py``).  Returns the records at P and H."""
    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    records, errs = {}, {}
    for tag, (b, l, h, p, n, q) in K8_CASES.items():
        x, dt, a_log, bm, cm = ssd_inputs(b, l, h, p, n, bf, dev, 60)
        dt = dt.float()          # as ops.ssd_scan hands it to K8
        ld = dt * -torch.exp(a_log)
        plan = kernel.plan(b, l, h, p, n, q, bf,
                           (bm.stride()[:3], cm.stride()[:3]), True, sms)
        lib = (kernel.smem_bytes("intra", p, n, q, plan.intra_slice),
               kernel.smem_bytes("state", p, n, q, plan.state_slice))
        if (plan.regime != "tensor_core"
                or lib != (plan.intra_smem, plan.state_smem)):
            raise AssertionError(f"K8 {tag}: plan {plan}, expected "
                                 f"tensor_core (library shared memory {lib})")
        got = ops._intra_chunk(x, ld, dt, bm, cm, q)
        want = ref.ssd_chunk_ref(x, ld, dt, bm, cm, q)
        err = max(attn_close(g, w, K8_TOL, f"K8 {tag} {name}") for name, g, w
                  in zip(("y_intra", "contrib", "total"), got, want))
        again = ops._intra_chunk(x, ld, dt, bm, cm, q)
        if not all(torch.equal(a, c) for a, c in zip(got, again)):
            raise AssertionError(f"K8 {tag}: two launches differ")
        packed = ops._intra_chunk(x, ld, dt, bm.contiguous(),
                                  cm.contiguous(), q)
        if not all(torch.equal(a, c) for a, c in zip(got, packed)):
            raise AssertionError(f"K8 {tag}: B and C shared across the "
                                 f"heads differ from packed copies")
        ms = time_ms(lambda: ops._intra_chunk(x, ld, dt, bm, cm, q))
        pms = time_ms(lambda: ref.ssd_chunk_ref(x, ld, dt, bm, cm, q))
        bound, by = k8_bound(b, l, h, p, n, q, 2)
        del got, want, again, packed
        log(f"{tag}: K8 {b}x{l}x{h}x{p}x{n} chunk {q} ({plan.regime}, "
            f"slices {plan.intra_slice}/{plan.state_slice}) err {err:.3e} "
            f"{ms:.4f} ms (plain {pms:.3f} ms, bound {bound:.4f} ms by {by}); "
            f"reruns and packed B, C bitwise equal")
        records[tag] = dict(
            name=f"ssd_scan {b}x{l}x{h}x{p}x{n}", route="cuda",
            source="src/repro_torch/kernels/ssd_scan/csrc/ssd_tc.cu",
            replaces="src/repro/kernels/ssd_scan/kernel.py:71",
            regime=plan.regime, slices=[plan.intra_slice, plan.state_slice],
            max_abs_err=err, rtol=K8_TOL, atol_per_rms=K8_TOL, ms=ms,
            plain_ms=pms, bound_ms=bound, bound_by=by, library_ms=None)
    x, dt, a_log, bm, cm = ssd_inputs(2, 40, 4, 16, 16, torch.float32, dev,
                                      70)
    bm, cm = bm * 0.3, cm * 0.3
    init = randn((2, 4, 16, 16), torch.float32, dev, 75) * 0.2
    y, state = ops.ssd_scan(x, dt, a_log, bm, cm, chunk=16, init_state=init)
    oy, ostate = ref.ssd_ref(x, dt, a_log, bm, cm, init_state=init)
    errs["ragged_f32"] = max(attn_close(y, oy, K8_TOL, "K8 ragged y"),
                             attn_close(state, ostate, K8_TOL,
                                        "K8 ragged state"))
    log(f"K8 float32 L 40 chunk 16 with an initial state, against ssd_ref: "
        f"err {errs['ragged_f32']:.3e}")
    for rec in records.values():
        rec["float32_max_abs_err"] = errs["ragged_f32"]
    return records


def check_d112(dev) -> tuple[list, dict]:
    """P1's check: K4, K5 and K6 at head dim 112 against their plain
    versions at path H's shapes, in bf16 and float32: K4 and K5 on a
    prefill of 8 x 512 with 32/32 heads (the tensor cores in bf16, the CUDA
    cores in float32, as their plans must choose; two launches bitwise
    equal), K6 over a 1024-position cache with ragged lengths, at Phi-2's
    head dim 80 (4 x 512, 32 heads) and on a case whose splits are all
    fully masked but one (two launches bitwise equal each).  The bf16 calls
    are timed beside the plain versions and SDPA.  Returns the records of
    K4 and K6 for path H, and K5's errors and times."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    b, s, hq, d, cache = 8, 512, 32, 112, 1024
    g = torch.Generator(device=dev).manual_seed(80)
    kv_len = torch.randint(1, cache + 1, (b,), generator=g, device=dev,
                           dtype=torch.int32)
    k4, k5, k6, k80, regimes = {}, {}, {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = attn_operands(b, s, s, hq, hq, d, dtype, dev, 81)
        want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        regimes[str(dtype)[6:]] = (
            attn_plan(q, k, v, want=want, what=f"K4 D 112 {dtype}").regime,
            attn_plan(q, k, v, do, want, f"K5 D 112 {dtype}").regime)
        k4[dtype] = k4_case(q, k, v, True, 0, f"K4 D 112 {dtype}")
        k5[str(dtype)[6:]], timed, _ = k5_case(
            q, k, v, do, True, 0, f"K5 D 112 {dtype}", bitwise=True)
        dq = randn((b, hq, d), dtype, dev, 84)
        dk, dv = (randn((b, cache, hq, d), dtype, dev, 85 + i)
                  for i in range(2))
        k6[dtype], p6 = k6_case(dq, dk, dv, kv_len, f"K6 D 112 {dtype}")
        # Phi-2's head dim (32 MHA heads of 80), outside K6's old fixed set.
        k80[str(dtype)[6:]], _ = k6_case(
            randn((4, 32, 80), dtype, dev, 95),
            randn((4, 512, 32, 80), dtype, dev, 96),
            randn((4, 512, 32, 80), dtype, dev, 97), kv_len[:4] // 2 + 1,
            f"K6 D 80 {dtype}")
    # K4 and K5 at head dim 80, which their wrappers pad to 112.
    d80 = {}
    for dtype in (torch.float32, torch.bfloat16):
        q80, k80_, v80, do80 = attn_operands(2, 256, 256, 8, 8, 80, dtype,
                                             dev, 98)
        d80[str(dtype)[6:]] = dict(
            k4=k4_case(q80, k80_, v80, True, 0, f"K4 D 80 {dtype}"),
            k5=k5_case(q80, k80_, v80, do80, True, 0, f"K5 D 80 {dtype}",
                       bitwise=True)[0])
    mq = randn((2, 4, d), torch.float32, dev, 87)
    mk = randn((2, 512, 4, d), torch.float32, dev, 88)
    mlen = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    masked, _ = k6_case(mq, mk, mk, mlen, "K6 D 112 fully masked splits", 64)

    bf = torch.bfloat16
    q, k, v, out, lse, do = timed
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ms4 = time_ms(lambda: fa_ops.flash_attention(q, k, v))
    pms4 = time_ms(lambda: fa_ref.flash_attention_ref(
        q, k, v, block_k=fa_ops.BLOCK_K))
    lms4 = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    pairs = s * (s + 1) // 2
    bound4, by4 = bound_ms(2 * 4 * b * s * hq * d + 4 * b * hq * s,
                           4 * b * hq * d * pairs, PEAK_BF16_FLOPS)
    ms5 = time_ms(lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, do))
    pms5 = time_ms(lambda: fa_ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, block_q=fa_ops.BLOCK_Q,
        block_k=fa_ops.BLOCK_K))
    both5 = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), do.transpose(1, 2)))
    bound5, by5 = bound_ms(2 * 8 * b * s * hq * d + 4 * b * hq * s,
                           10 * b * hq * d * pairs, PEAK_BF16_FLOPS)
    k5_d112 = dict(regimes=regimes, errs=k5, ms=ms5, plain_ms=pms5,
                   library_ms=both5 - lms4, bound_ms=bound5, bound_by=by5,
                   d80={k: v["k5"] for k, v in d80.items()})
    log(f"H: K5 D 112 regimes {json.dumps(regimes)} errs {json.dumps(k5)} "
        f"{ms5:.4f} ms (plain {pms5:.3f} ms, SDPA backward "
        f"{both5 - lms4:.4f} ms, bound {bound5:.4f} ms)")
    times6 = time_k6(dq, dk, dv, kv_len)
    log(f"H: K4 D 112 ({regimes['bfloat16'][0]}) err {k4[bf]:.3e} (float32 "
        f"{k4[torch.float32]:.3e}) "
        f"{ms4:.4f} ms (plain {pms4:.3f} ms, SDPA {lms4:.4f} ms, bound "
        f"{bound4:.4f} ms); K6 D 112 (split {p6.split}) err {k6[bf]:.3e} "
        f"(float32 {k6[torch.float32]:.3e}, masked {masked:.3e}; D 80 "
        f"{json.dumps(k80)}) {times6['ms']:.4f} ms (plain "
        f"{times6['plain_ms']:.3f} ms, SDPA {times6['library_ms']:.4f} ms, "
        f"bound {times6['bound_ms']:.5f} ms), reruns bitwise equal, kv_len "
        f"{kv_len.tolist()}; K4 and K5 at D 80 (padded to 112) "
        f"{json.dumps(d80)}")
    src = "src/repro_torch/kernels/"
    return [dict(name=f"flash_attention {b}x{s}x{hq}x{d}", route="cuda",
                 source=src + "flash_attention/csrc/flash_fwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:83",
                 regime=regimes["bfloat16"][0], max_abs_err=k4[bf],
                 float32_max_abs_err=k4[torch.float32],
                 d80_max_abs_err={k: v["k4"] for k, v in d80.items()},
                 rtol=ATTN_TOL[bf], atol_per_rms=ATTN_TOL[bf], ms=ms4,
                 plain_ms=pms4, bound_ms=bound4, bound_by=by4,
                 library_ms=lms4),
            k6_record((b, cache, hq, d), k6[bf], k6[torch.float32], p6,
                      times6, masked_max_abs_err=masked,
                      d80_max_abs_err=k80)], k5_d112


@contextlib.contextmanager
def plain_ssd():
    """The SSD scan's intra-chunk step through K8's plain version and its
    backward through K8b's (the comparison runs only)."""
    from repro_torch.kernels.ssd_scan import ops, ref

    with mock.patch.object(ops, "_intra_chunk", ref.ssd_chunk_ref), \
            mock.patch.object(ops, "ssd_chunk_bwd", ref.ssd_chunk_bwd_ref):
        yield


def run_ssm_serving_path(tag: str, dev) -> tuple[dict, dict]:
    """Path P or H through ``launch.serve.main`` on the card, with the
    launch counts of exactly that run (K8 once a layer a prefill; for the
    hybrid K4 once a site a prefill and K6 once a site a decode step; K1-K3
    as the same cap event's CPU run calls their plain versions); its cap
    event held against the CPU; one replica's batch fed back through the
    plain versions on the card (logits within 2e-2 relative L2); then warm
    timings."""
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_loop import generate

    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(SSM_ARGV[tag])
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg, params = report.cfg, report.params
    steps, max_len, prompt_len = 32, 1024, 512
    n_rep = len(report.routing)
    sites = cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    power_launches = hold_cap_event(tag, report, 16, n_rep)
    want = dict(power_launches, flash_attention=sites * n_rep,
                flash_attention_bwd=0,
                decode_attention=sites * (steps - 1) * n_rep,
                grouped_matmul=0, ssd_scan=cfg.n_layers * n_rep,
                ssd_scan_bwd=0)
    family = {"P": "ssm", "H": "hybrid"}[tag]
    if cfg.family != family or launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want}")
    if report.routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"{tag}: routing {report.routing}")
    for rep, (prompts, toks, logits) in report.batches.items():
        if toks.shape != (8, steps) or logits.shape != (8, steps,
                                                        cfg.vocab_size):
            raise AssertionError(f"{tag} {rep}: shapes {toks.shape}, "
                                 f"{logits.shape}")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} {rep}: non-finite logits")
    prompts, toks, logits = report.batches["rep0"]
    with plain_attention(), plain_ssd():
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks)
    err = rel_l2(logits, plain_logits)
    if not err <= 2e-2:
        raise AssertionError(f"{tag}: teacher-forced logits {err:.3e} "
                             f"relative L2 from the plain versions (bound "
                             f"2e-2)")
    same = float((plain_logits.argmax(-1) == toks).float().mean())
    del plain_logits

    prefill_ms, step_ms = warm_serve_ms(cfg, params, prompts, None, steps,
                                        max_len, 3)
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    info = dict(wall_s=wall, decode_s=report.seconds, tokens=report.tokens,
                tokens_per_s=report.tokens / report.seconds,
                prefill_ms=prefill_ms,
                decode_step_ms=step_ms,
                weights_gb=weights_gb, peak_memory_gb=peak_gb,
                teacher_forced_rel_l2=err, plain_argmax_equal=same,
                routing=report.routing, routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, steps=steps,
                params=cfg.param_count())
    info["decode_graph"] = check_decode_graph(tag, cfg, params, prompts,
                                              None, steps, max_len)
    log(f"path {tag}: {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole driver {wall:.3f} s); "
        f"prefill {info['prefill_ms']:.2f} ms, decode step "
        f"{info['decode_step_ms']:.2f} ms (warm, one batch of 8); weights "
        f"{weights_gb:.3f} GB, peak {peak_gb:.3f} GB; teacher-forced logits "
        f"{err:.3e} relative L2 (argmax equal {same:.3f}); launches "
        f"{launches}; cap event {report.caps_after} W, "
        f"{report.routing_after}, {report.notes}")
    return launches, info


def run_ssm_f32_check(arch: str, n_layers: int, dev) -> dict:
    """``arch`` at full width and ``n_layers`` layers in float32: greedy
    tokens identical through the kernels and through the plain versions,
    logits within 1e-4 relative L2, on one batch of 8 prompts of 512."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = dataclasses.replace(configs.get(arch), n_layers=n_layers,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, 512), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    toks, logits = generate(cfg, params, prompts, 32, 1024)
    with plain_attention(), plain_ssd():
        ptoks, plogits = generate(cfg, params, prompts, 32, 1024)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks):
        raise AssertionError(f"{arch} f32: greedy tokens differ between the "
                             f"kernels and the plain versions")
    if not err <= 1e-4:
        raise AssertionError(f"{arch} f32: logits {err:.3e} relative L2 "
                             f"from the plain versions (bound 1e-4)")
    log(f"{arch} f32, {n_layers} layers: tokens identical, logits "
        f"{err:.3e} relative L2")
    return dict(n_layers=n_layers, rel_l2=err, tokens_identical=True)


#: K7's backward at path TM's products (OLMoE-1B-7B, a microbatch of 2 x
#: 4096 tokens, C = 1280): ``(E, C, D, F)`` of the forward product whose
#: backward runs (dX as ``(E, C, F) @ (E, F, D)``, dW as ``(E, D, C) @ (E,
#: C, F)``): the gate and up products and the down product.
K7_BWD_CASES = {"gate": (64, 1280, 2048, 1024), "up": (64, 1280, 2048, 1024),
                "down": (64, 1280, 1024, 2048)}


#: K7's backward on views (``(E, C, D, F)``, bf16 and float32): x and w
#: are views into allocations whose rows past C or D and columns past D or
#: F hold NaN, so the backward reads ``X^T`` and ``W^T`` through pitches of
#: the larger allocation; "view_nan" at pitches TMA reads (the wide
#: regime in bf16), "bad_pitch" at pitches it cannot (the CUDA-core kernel
#: in both dtypes), each ragged against the kernels' tiles.
K7_BWD_VIEWS = {"view_nan": ((4, 300, 200, 136), 16),
                "bad_pitch": ((4, 300, 200, 136), 3)}


def k7_bwd_view(e, c, d, f, pad, dtype, dev, seed: int):
    """x (E, C, D) and w (E, D, F) as views into NaN-filled allocations
    with ``pad`` extra rows and columns, filled from ``seed``."""
    xb = torch.full((e, c + pad, d + pad), float("nan"), dtype=dtype,
                    device=dev)
    wb = torch.full((e, d + pad, f + pad), float("nan"), dtype=dtype,
                    device=dev)
    xb[:, :c, :d] = randn((e, c, d), dtype, dev, seed)
    wb[:, :d, :f] = (randn((e, d, f), torch.float32, dev, seed + 1)
                     * d ** -0.5).to(dtype)
    return xb[:, :c, :d], wb[:, :d, :f]


def on_fresh_thread(fn):
    """``fn()`` on a new host thread whose first CUDA work it is, as the
    first launch on autograd's worker thread can be; its result, or its
    exception raised here."""
    out = {}

    def run():
        try:
            out["value"] = fn()
            torch.cuda.synchronize()
        except BaseException as exc:     # handed to the caller
            out["error"] = exc
    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def check_k7_bwd(dev) -> dict:
    """K7's backward (two K7 launches through ``GroupedMatmul``, reading
    ``W^T`` and ``X^T`` in place) against its plain version
    ``grouped_matmul_bwd_ref`` on the card, at path TM's three products in
    bf16 (the wide regime, the attention kernels' tolerance) and float32
    (the CUDA-core kernel, 1e-5, both relative to the values' scale), and
    on views into NaN-filled allocations (:data:`K7_BWD_VIEWS`), each
    product in the regime and layout its plan must choose, three launches
    a forward and backward, two backward passes bitwise equal (a view
    case's also from a fresh host thread, whose first CUDA work it is:
    autograd's worker thread can start so); the bf16 backward at TM's
    products timed beside its plain version,
    ``torch.bmm`` on the same operands (dX and dW), the parent design on
    the same card (the two launches on contiguous copies of the transposed
    operands) and those copies alone, the cost the redesign removed.
    Returns K7's record at TM's gate product's backward."""
    from repro_torch.kernels.moe_gmm import kernel, ops, ref

    cases = {}
    shapes = [(case, shape, None) for case, shape in K7_BWD_CASES.items()]
    shapes += [(case, shape, pad)
               for case, (shape, pad) in K7_BWD_VIEWS.items()]
    for i, (case, (e, c, d, f), pad) in enumerate(shapes):
        for dtype in (torch.bfloat16, torch.float32):
            name = f"{case}_{str(dtype)[6:]}"
            if pad is None:
                x = randn((e, c, d), dtype, dev, 90 + i)
                w = (randn((e, d, f), torch.float32, dev, 93 + i)
                     * d ** -0.5).to(dtype)
            else:
                x, w = k7_bwd_view(e, c, d, f, pad, dtype, dev, 90 + i)
            x.requires_grad_()
            w.requires_grad_()
            dy = randn((e, c, f), dtype, dev, 96 + i)
            wt, xt = ops.transposed_operands(x.detach(), w.detach())
            plans = (kernel.plan(e, c, f, d, dtype, (dy.stride(),
                                                     wt.stride())),
                     kernel.plan(e, d, c, f, dtype, (xt.stride(),
                                                     dy.stride())))
            regime = ("wide" if dtype == torch.bfloat16 and pad != 3
                      else "cuda_core")
            if not (all(pl.regime == regime for pl in plans)
                    and (plans[0].x_t, plans[0].w_t) == (False, True)
                    and (plans[1].x_t, plans[1].w_t) == (True, False)):
                raise AssertionError(f"K7 backward {name}: plans {plans}, "
                                     f"expected {regime} reading W^T and "
                                     f"X^T in place")

            def backward():
                return torch.autograd.grad(ops.grouped_matmul(x, w), (x, w),
                                           dy)
            before = ops.grouped_matmul.launches
            got = backward()
            if ops.grouped_matmul.launches - before != 3:
                raise AssertionError(f"K7 backward {name}: "
                                     f"{ops.grouped_matmul.launches - before}"
                                     f" launches for a forward and backward")
            want = ref.grouped_matmul_bwd_ref(x.detach(), w.detach(), dy)
            tol = K7_BWD_TOL[dtype]
            err = max(attn_close(g, wt_, tol, f"K7 backward {name} {gn}")
                      for gn, g, wt_ in zip(("dx", "dw"), got, want))
            if not all(torch.equal(a, b) for a, b in zip(got, backward())):
                raise AssertionError(f"K7 backward {name}: two passes differ")
            rec = dict(shape=[e, c, d, f], dtype=str(dtype)[6:],
                       regime=regime, max_abs_err=err, rtol=tol,
                       atol_per_rms=tol)
            if dtype == torch.bfloat16 and pad is None:
                out = ops.grouped_matmul(x, w)
                xd, wd = x.detach(), w.detach()
                rec["ms"] = time_ms(lambda: torch.autograd.grad(
                    out, (x, w), dy, retain_graph=True))
                rec["plain_ms"] = time_ms(
                    lambda: ref.grouped_matmul_bwd_ref(xd, wd, dy))
                rec["library_ms"] = time_ms(
                    lambda: (torch.bmm(dy, wd.transpose(1, 2)),
                             torch.bmm(xd.transpose(1, 2), dy)))
                rec["copied_operands_ms"] = time_ms(
                    lambda: (ops._gmm(dy, wd.transpose(1, 2).contiguous()),
                             ops._gmm(xd.transpose(1, 2).contiguous(), dy)))
                rec["transpose_copies_ms"] = time_ms(
                    lambda: (wd.transpose(1, 2).contiguous(),
                             xd.transpose(1, 2).contiguous()))
                rec["bound_ms"], rec["bound_by"] = bound_ms(
                    2 * (2 * e * c * d + 2 * e * d * f + e * c * f),
                    2 * 2.0 * e * c * d * f, PEAK_BF16_FLOPS)
                del out
            cases[name] = rec
            log(f"TM: K7 backward {name} {e}x{c}x{d}x{f} ({regime}) err "
                f"{err:.3e}"
                + (f" {rec['ms']:.4f} ms (plain {rec['plain_ms']:.3f} ms, "
                   f"bmm {rec['library_ms']:.4f} ms; the parent's copied "
                   f"operands {rec['copied_operands_ms']:.4f} ms, the "
                   f"copies alone {rec['transpose_copies_ms']:.4f} ms; "
                   f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']})"
                   if "ms" in rec else "") + "; rerun bitwise equal")
            if case == "view_nan" and dtype == torch.bfloat16:
                # The backward's first launches on a thread that has not
                # used the card: bitwise what the main thread gives.
                if not all(torch.equal(a, b) for a, b in zip(
                        got, on_fresh_thread(backward))):
                    raise AssertionError(f"K7 backward {name}: a fresh "
                                         f"thread's pass differs")
                rec["fresh_thread_bitwise"] = True
            del x, w, dy, got, want, wt, xt
    main = cases["gate_bfloat16"]
    return dict(name="grouped_matmul backward 64x1280x2048x1024",
                route="cuda",
                source="src/repro_torch/kernels/moe_gmm/csrc/gmm_tc.cu",
                replaces="src/repro/kernels/moe_gmm/kernel.py:46",
                max_abs_err=max(r["max_abs_err"] for r in cases.values()
                                if r["dtype"] == "bfloat16"),
                float32_max_abs_err=max(r["max_abs_err"]
                                        for r in cases.values()
                                        if r["dtype"] == "float32"),
                rtol=K7_BWD_TOL[torch.bfloat16],
                atol_per_rms=K7_BWD_TOL[torch.bfloat16], ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                transpose_copies_ms=main["transpose_copies_ms"],
                copied_operands_ms=main["copied_operands_ms"],
                cases=cases)


#: K7's backward tolerances: the attention kernels' in bf16, 1e-5 in
#: float32 (its CUDA-core kernel against cuBLAS, both summing in float32),
#: relative to the values' scale (:func:`attn_close`).
K7_BWD_TOL = {torch.bfloat16: ATTN_TOL[torch.bfloat16], torch.float32: 1e-5}
#: K8b's cases at paths TP's and TH's call (one sequence of 4096 a
#: microbatch, chunk 256): ``(B, L, H, P, N, Q)``.
K8B_CASES = {"TP": (1, 4096, 80, 64, 128, 256),
             "TH": (1, 4096, 112, 64, 64, 256)}
#: K8b's tolerances, relative L2 in float32 (both sum in float32, in other
#: orders) and :func:`attn_close`'s in bf16 inputs.
K8B_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def k8b_bound(b, l, h, p, n, q, el) -> tuple[float, str]:
    """K8b's least time, whatever runs it: x (``el`` bytes), B and C (one
    row shared by the heads), the log decay, dt, dy, dcontrib and dtotal
    read once and its five float32 outputs written once (db and dc a head
    each); the causal pairs' five products (S, G, dx, dB, dC) and the
    contrib terms' two, over the bf16 tensor-core peak for bf16 inputs
    (the card runs them there) and the float32 peak for float32 ones."""
    nc = l // q
    n_bytes = (el * (b * l * h * p + 2 * b * l * n)
               + 4 * (2 * b * l * h + b * l * h * p + b * nc * h * p * n
                      + b * nc * h)
               + 4 * (b * l * h * p + 2 * b * l * h + 2 * b * l * h * n))
    flops = b * nc * h * (q * (q + 1) * (3 * n + 2 * p) + 4 * q * p * n)
    return bound_ms(n_bytes, flops, PEAK_BF16_FLOPS if el == 2
                    else PEAK_FP32_FLOPS)


#: A bf16 call that K8b's tensor-core regime refuses (P 32): the CUDA-core
#: kernel with bf16 inputs, ``(B, L, H, P, N, Q)``.
K8B_CUDA_CORE_BF16 = (1, 512, 8, 32, 64, 128)
#: bf16 calls of the tensor-core regime at the shapes the paths do not
#: give it: two sequences (the batch's offsets), chunks of 128 and 64,
#: both widths of N.
K8B_TC_SHAPES = [(2, 384, 6, 64, 64, 128), (2, 256, 4, 64, 128, 64)]


def k8b_operands(b, l, h, p, n, q, dtype, dev, seed: int):
    """K8b's inputs at one call: x, the log decay, dt, B and C one row
    shared by the heads and read from views into NaN-filled allocations
    (T3), and float32 cotangents of y_intra, contrib and total."""
    x, dt, a_log, bm, cm = ssd_inputs(b, l, h, p, n, dtype, dev, seed)
    views = []
    for t in (bm, cm):
        big = torch.full((b, l, 2, n + 8), float("nan"), dtype=dtype,
                         device=dev)
        big[:, :, :1, :n] = t[:, :, :1]
        views.append(big[:, :, :1, :n].expand(b, l, h, n))
    bm, cm = views
    dt = dt.float()
    ld = dt * -torch.exp(a_log)
    nc = l // q
    return (x, ld, dt, bm, cm, q,
            randn((b, l, h, p), torch.float32, dev, seed + 5),
            randn((b, nc, h, p, n), torch.float32, dev, seed + 6),
            randn((b, nc, h), torch.float32, dev, seed + 7))


def k8b_plan(args):
    from repro_torch.kernels.ssd_scan import kernel

    x, _, _, bm, cm, q = args[:6]
    b, l, h, p = x.shape
    return kernel.plan_bwd(b, l, h, p, bm.shape[-1], q, x.dtype,
                           (bm.stride()[:3], cm.stride()[:3]), True)


def check_k8b(dev) -> dict:
    """K8b against ``ref.ssd_chunk_bwd_ref`` on the card at paths TP's and
    TH's calls, in float32 (the CUDA-core kernel, 1e-5 relative L2) and
    with bf16 x, B and C (the tensor-core regime, :func:`attn_close` at
    2e-2, each of the five outputs' error printed), B and C one row shared
    by the heads and read from views into NaN-filled allocations (T3), each
    in the regime its plan must choose with the plan's shared memory the
    library's own count, two launches bitwise equal, the bf16 call with B
    and C packed bitwise equal to the shared one; a bf16 call the
    tensor-core regime refuses (P 32) on the CUDA-core kernel, and bf16
    calls of the tensor-core regime at two sequences with chunks of 128
    and 64 (:data:`K8B_TC_SHAPES`), reruns bitwise equal (one from a fresh
    host thread); then K8's
    forward at the same shapes against its plain version (K8's tolerance);
    each timed beside its plain version (K8b in bf16 beside the CUDA-core
    kernel on the same inputs too, the parent design); then the scan's
    float32 gradient on a ragged tail through K8 and K8b against the plain
    versions (1e-5 relative L2).  Returns ``{tag: [K8b's record, K8's
    record]}``."""
    from repro_torch.kernels.ssd_scan import kernel, ops, ref

    names = ("dx", "dlog_decay", "ddt", "db", "dc")
    out = {}
    for tag, (b, l, h, p, n, q) in K8B_CASES.items():
        nc = l // q
        errs, timed, plans = {}, {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            args = k8b_operands(b, l, h, p, n, q, dtype, dev, 80)
            plan = plans[str(dtype)[6:]] = k8b_plan(args)
            regime = ("tensor_core" if dtype == torch.bfloat16
                      else "cuda_core")
            if (plan.regime != regime or plan.smem_bytes
                    != kernel.bwd_smem_bytes(p, n, q, regime)):
                raise AssertionError(
                    f"K8b {tag} {dtype}: plan {plan}, expected {regime} "
                    f"with the library's "
                    f"{kernel.bwd_smem_bytes(p, n, q, regime)} B")
            got = ops.ssd_chunk_bwd(*args)
            want = ref.ssd_chunk_bwd_ref(*args)
            if dtype == torch.float32:
                errs["float32"] = {}
                for name, g, w in zip(names, got, want):
                    e = rel_l2(g, w)
                    if not (torch.isfinite(g).all() and e <= K8B_TOL[dtype]):
                        raise AssertionError(
                            f"K8b {tag} float32 {name}: {e:.3e} relative L2 "
                            f"from the plain version (bound 1e-5)")
                    errs["float32"][name] = e
            else:
                errs["bfloat16"] = {
                    name: attn_close(g, w, K8B_TOL[dtype],
                                     f"K8b {tag} bf16 {name}")
                    for name, g, w in zip(names, got, want)}
                x, ld, dt, bm, cm = args[:5]
                packed = (x, ld, dt, bm.contiguous(), cm.contiguous()) \
                    + args[5:]
                if k8b_plan(packed).regime != "tensor_core" or not all(
                        torch.equal(a, c) for a, c in
                        zip(got, ops.ssd_chunk_bwd(*packed))):
                    raise AssertionError(f"K8b {tag} bf16: packed B and C "
                                         f"differ from shared ones")
                del packed
            if not all(torch.equal(a, c) for a, c in
                       zip(got, ops.ssd_chunk_bwd(*args))):
                raise AssertionError(f"K8b {tag} {dtype}: two launches "
                                     f"differ")
            del got, want
            if dtype == torch.bfloat16:
                x, ld, dt, bm, cm = args[:5]
                core = kernel.BwdPlan((h, b * nc, 1), kernel.BWD_THREADS,
                                      kernel.bwd_smem(p, n, q))
                f32 = dict(dtype=torch.float32, device=dev)
                outs = [torch.empty(sh, **f32) for sh in (
                    (b, l, h, p), (b, l, h), (b, l, h), (b, l, h, n),
                    (b, l, h, n))]
                timed = dict(
                    ms=time_ms(lambda: ops.ssd_chunk_bwd(*args)),
                    plain_ms=time_ms(lambda: ref.ssd_chunk_bwd_ref(*args)),
                    cuda_core_ms=time_ms(lambda: kernel.ssd_chunk_bwd(
                        x, ld, dt, bm, cm, *args[6:], *outs, core,
                        chunk=q)))
                del outs
                fwd = ops._intra_chunk(x, ld, dt, bm, cm, q)
                fwd_err = max(attn_close(g, w, K8_TOL, f"K8 at {tag} {nm}")
                              for nm, g, w in zip(
                                  ("y_intra", "contrib", "total"), fwd,
                                  ref.ssd_chunk_ref(x, ld, dt, bm, cm, q)))
                del fwd
                k8_ms = time_ms(lambda: ops._intra_chunk(x, ld, dt, bm, cm,
                                                         q))
                k8_pms = time_ms(lambda: ref.ssd_chunk_ref(x, ld, dt, bm, cm,
                                                           q))
            del args
        bound, by = k8b_bound(b, l, h, p, n, q, 2)
        k8_b, k8_by = k8_bound(b, l, h, p, n, q, 2)
        log(f"{tag}: K8b {b}x{l}x{h}x{p}x{n} chunk {q} (bf16 "
            f"{plans['bfloat16']}; float32 {plans['float32']}) float32 "
            f"relative L2 {json.dumps(errs['float32'])}, bf16 max abs "
            f"{json.dumps(errs['bfloat16'])}; {timed['ms']:.4f} ms (the "
            f"CUDA-core kernel on the same bf16 inputs "
            f"{timed['cuda_core_ms']:.4f} ms, plain "
            f"{timed['plain_ms']:.3f} ms, bound {bound:.4f} ms by {by}); "
            f"K8 at the same call err {fwd_err:.3e} {k8_ms:.4f} ms (plain "
            f"{k8_pms:.3f} ms, bound {k8_b:.4f} ms by {k8_by}); reruns "
            f"and packed B and C bitwise equal")
        out[tag] = [
            dict(name=f"ssd_scan_bwd {b}x{l}x{h}x{p}x{n}", route="cuda",
                 source="src/repro_torch/kernels/ssd_scan/csrc/"
                        "ssd_bwd_tc.cu",
                 cuda_core_source="src/repro_torch/kernels/ssd_scan/csrc/"
                                  "ssd_bwd.cu",
                 replaces="src/repro/kernels/ssd_scan/kernel.py:71 (its "
                          "backward: the reference differentiates "
                          "src/repro/models/ssd.py:ssd_chunked)",
                 max_abs_err=max(errs["bfloat16"].values()),
                 bf16_max_abs_err=errs["bfloat16"],
                 float32_rel_l2=errs["float32"], rtol=K8B_TOL[torch.bfloat16],
                 atol_per_rms=K8B_TOL[torch.bfloat16], ms=timed["ms"],
                 plain_ms=timed["plain_ms"],
                 cuda_core_ms=timed["cuda_core_ms"], bound_ms=bound,
                 bound_by=by, library_ms=None,
                 smem_bytes=plans["bfloat16"].smem_bytes),
            dict(name=f"ssd_scan {b}x{l}x{h}x{p}x{n}", route="cuda",
                 source="src/repro_torch/kernels/ssd_scan/csrc/ssd_tc.cu",
                 replaces="src/repro/kernels/ssd_scan/kernel.py:71",
                 max_abs_err=fwd_err, rtol=K8_TOL, atol_per_rms=K8_TOL,
                 ms=k8_ms, plain_ms=k8_pms, bound_ms=k8_b,
                 bound_by=k8_by, library_ms=None)]
    # A bf16 call the tensor-core regime refuses: the CUDA-core kernel.
    args = k8b_operands(*K8B_CUDA_CORE_BF16, torch.bfloat16, dev, 70)
    if k8b_plan(args).regime != "cuda_core":
        raise AssertionError(f"K8b at {K8B_CUDA_CORE_BF16}: plan "
                             f"{k8b_plan(args)}, expected cuda_core")
    got = ops.ssd_chunk_bwd(*args)
    core_bf16 = {name: attn_close(g, w, K8B_TOL[torch.bfloat16],
                                  f"K8b bf16 P 32 {name}")
                 for name, g, w in zip(names, got,
                                       ref.ssd_chunk_bwd_ref(*args))}
    log(f"K8b: bf16 at {K8B_CUDA_CORE_BF16} on the CUDA cores, max abs "
        f"{json.dumps(core_bf16)}")
    del args, got
    for shape in K8B_TC_SHAPES:
        args = k8b_operands(*shape, torch.bfloat16, dev, 60)
        if k8b_plan(args).regime != "tensor_core":
            raise AssertionError(f"K8b at {shape}: plan {k8b_plan(args)}, "
                                 f"expected tensor_core")
        got = ops.ssd_chunk_bwd(*args)
        errs = {name: attn_close(g, w, K8B_TOL[torch.bfloat16],
                                 f"K8b bf16 {shape} {name}")
                for name, g, w in zip(names, got,
                                      ref.ssd_chunk_bwd_ref(*args))}
        if not all(torch.equal(a, c) for a, c in
                   zip(got, ops.ssd_chunk_bwd(*args))):
            raise AssertionError(f"K8b bf16 {shape}: two launches differ")
        if not all(torch.equal(a, c) for a, c in zip(
                got, on_fresh_thread(lambda: ops.ssd_chunk_bwd(*args)))):
            raise AssertionError(f"K8b bf16 {shape}: a fresh thread's "
                                 f"launch differs")
        log(f"K8b: bf16 at {shape} on the tensor cores, max abs "
            f"{json.dumps(errs)}; reruns (one on a fresh thread) bitwise "
            f"equal")
        del args, got
    # The scan's gradient in every input through K8 and K8b against the
    # plain versions, float32, on a ragged tail with an initial state:
    # chunks of 16, so K8b's 64-row tiles are mostly masked.
    x, dt, a_log, bm, cm = ssd_inputs(2, 40, 4, 16, 16, torch.float32, dev,
                                      88)
    init = randn((2, 4, 16, 16), torch.float32, dev, 89) * 0.2
    leaves_in = [t.detach().clone().requires_grad_()
                 for t in (x, dt, a_log, bm[:, :, :1] * 0.3,
                           cm[:, :, :1] * 0.3, init)]
    cots = (randn((2, 40, 4, 16), torch.float32, dev, 90),
            randn((2, 4, 16, 16), torch.float32, dev, 91))

    def scan_grads():
        y, state = ops.ssd_scan(*leaves_in[:3],
                                leaves_in[3].expand(2, 40, 4, 16),
                                leaves_in[4].expand(2, 40, 4, 16), chunk=16,
                                init_state=leaves_in[5])
        return torch.autograd.grad((y, state), leaves_in, cots)
    before = ops.ssd_chunk_bwd.launches
    got = scan_grads()
    if ops.ssd_chunk_bwd.launches != before + 1:
        raise AssertionError("K8b: the scan's backward did not launch it")
    with plain_ssd():
        want = scan_grads()
    ragged = {name: rel_l2(g, w) for name, g, w in zip(
        ("x", "dt", "a_log", "b", "c", "init"), got, want)}
    if not all(e <= K8B_TOL[torch.float32] for e in ragged.values()):
        raise AssertionError(f"K8b: the ragged scan's gradient {ragged} "
                             f"relative L2 from the plain versions (bound "
                             f"1e-5)")
    log(f"K8b: float32 scan gradient, L 40 chunk 16 with an initial state, "
        f"against the plain versions: {json.dumps(ragged)} relative L2")
    for recs in out.values():
        recs[0]["ragged_scan_grad_rel_l2"] = ragged
        recs[0]["cuda_core_bf16_max_abs_err"] = core_bf16
    return out


#: K4 and K5 at paths TM's and TH's layers: ``(B, S, H, D)``, causal,
#: bf16, as many KV heads as query heads (OLMoE's 16 of 128 on a
#: microbatch of 2 x 4096, Zamba2's 32 of 112 on one of 4096).
TRAIN_ATTN_CASES = {"TM": (2, 4096, 16, 128), "TH": (1, 4096, 32, 112)}


def check_train_attention(tag: str, dev) -> list:
    """K4 and K5 at path ``tag``'s layer against their plain versions
    (bf16, the tensor cores as their plans must choose, two launches
    bitwise equal), timed beside the plain versions and SDPA; returns
    their records."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    b, s, h, d = TRAIN_ATTN_CASES[tag]
    bf = torch.bfloat16
    q, k, v, do = attn_operands(b, s, s, h, h, d, bf, dev, 110)
    attn_plan(q, k, v, want="tensor_core", what=f"K4 at {tag}")
    regime = attn_plan(q, k, v, do, "tensor_core", f"K5 at {tag}").regime
    k4_err = k4_case(q, k, v, True, 0, f"K4 at {tag}")
    errs, (q, k, v, out, lse, do), _ = k5_case(q, k, v, do, True, 0,
                                                f"K5 at {tag}", True)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    both_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), dot))
    pairs = s * (s + 1) // 2
    k4_ms = time_ms(lambda: ops.flash_attention(q, k, v))
    k4_pms = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                     block_k=ops.BLOCK_K))
    k4_bound, k4_by = bound_ms(2 * 4 * b * s * h * d + 4 * b * h * s,
                               4 * b * h * d * pairs, PEAK_BF16_FLOPS)
    k5_ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, out, lse, do))
    k5_pms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
    k5_bound, k5_by = bound_ms(2 * 8 * b * s * h * d + 4 * b * h * s,
                               10 * b * h * d * pairs, PEAK_BF16_FLOPS)
    log(f"{tag}: K4 at {b}x{s}x{h}x{d} err {k4_err:.3e} {k4_ms:.3f} ms "
        f"(plain {k4_pms:.3f} ms, SDPA {fwd_ms:.3f} ms, bound "
        f"{k4_bound:.4f} ms); K5 ({regime}) errs {json.dumps(errs)} "
        f"{k5_ms:.3f} ms (plain {k5_pms:.3f} ms, SDPA backward "
        f"{both_ms - fwd_ms:.3f} ms, bound {k5_bound:.4f} ms)")
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    common = dict(route="cuda", regime=regime, rtol=ATTN_TOL[bf],
                  atol_per_rms=ATTN_TOL[bf])
    return [dict(common, name=f"flash_attention {b}x{s}x{h}x{d}",
                 source=src + "flash_fwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel.py:83",
                 max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_pms,
                 bound_ms=k4_bound, bound_by=k4_by, library_ms=fwd_ms),
            dict(common, name=f"flash_attention_bwd {b}x{s}x{h}x{d}",
                 source=src + "flash_bwd_tc.cu",
                 replaces="src/repro/kernels/flash_attention/kernel_bwd.py"
                          ":125",
                 max_abs_err=max(errs.values()), ms=k5_ms, plain_ms=k5_pms,
                 bound_ms=k5_bound, bound_by=k5_by,
                 library_ms=both_ms - fwd_ms)]


@contextlib.contextmanager
def plain_kernels():
    """Every model kernel through its plain version: attention (K4, K5,
    K6), the experts (K7 and its backward: autograd of the plain einsum)
    and the SSD scan (K8, K8b).  The comparison runs only."""
    with plain_attention(), plain_experts(), plain_ssd():
        yield


#: Paths TM, TP and TH: the training driver at OLMoE-1B-7B's, Mamba2-2.7B's
#: and Zamba2-7B's full width, path T's sequences, pods and budget cut in
#: 4 steps (the straggler stays on path T), each config's own
#: microbatches; ``(arch, layers kept or None)``: OLMoE at 8 of its 16
#: layers and Zamba2 at 36 of its 81 (6 shared-attention sites), where
#: bf16 parameters and gradients with float32 moments and gradient sums
#: (about 16 B a parameter) would not fit 80 GB at full depth.
FAMILY_PATHS = {"TM": ("olmoe_1b_7b", 1), "TP": ("mamba2_2p7b", 8),
                "TH": ("zamba2_7b", 6)}
FAMILY_EVENTS = ["--global-batch", "4", "--pods", "2", "--steps", "4",
                 "--power-budget-drop-at", "1", "--checkpoint-every", "0"]


@contextlib.contextmanager
def depth_cut(n_layers):
    """``configs.get`` as the training driver calls it, with the depth cut
    to ``n_layers`` (None: as it is)."""
    from repro_torch import configs
    real = configs.get
    if n_layers is None:
        yield
        return
    with mock.patch.object(configs, "get", lambda arch: dataclasses.replace(
            real(arch), n_layers=n_layers)):
        yield


def family_launches(cfg, steps: int) -> dict:
    """The model kernels' launches of ``steps`` training steps: each layer
    a microbatch runs its forward, its recompute under remat and its
    backward.  MoE: K7 3 + 3 + 6 (two a product's backward), K4 twice and
    K5 once (the decoder block is checkpointed whole); SSM: K8 1 + 1 and
    K8b once; the hybrid's shared attention (not checkpointed, as the
    reference has it): K4 and K5 once a site."""
    mb = max(cfg.microbatches, 1) * steps
    n = dict.fromkeys(_model_wrappers(), 0)
    if cfg.family == "moe":
        n.update(grouped_matmul=12 * cfg.n_layers * mb,
                 flash_attention=2 * cfg.n_layers * mb,
                 flash_attention_bwd=cfg.n_layers * mb)
    else:
        sites = cfg.n_layers // cfg.attn_every if cfg.attn_every else 0
        n.update(ssd_scan=2 * cfg.n_layers * mb,
                 ssd_scan_bwd=cfg.n_layers * mb,
                 flash_attention=sites * mb, flash_attention_bwd=sites * mb)
    return n


def run_family_training_path(tag: str, dev) -> tuple[dict, dict]:
    """Path TM, TP or TH through ``launch.train.main`` on the card, with
    the launch counts of exactly that run; its power plane held against
    the same events on the CPU (plans, caps, K1-K3 launches); finite losses
    and gradient norms; one step's loss and gradients through the kernels
    against the plain versions on the card in bf16 at the path's depth
    (TP, TH: loss 1e-2 relative, every gradient 5e-2 relative L2, path T's
    bounds; TM: one layer's backward rerun bit for bit instead,
    ``moe_layer_rerun``), after two warm steps timed by CUDA events and a
    third traced (the device's idle share)."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import train
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import make_grads_fn, make_train_step

    arch, n_layers = FAMILY_PATHS[tag]
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with depth_cut(n_layers):
            report = train.main(["--arch", arch, "--seq-len", "4096"]
                                + FAMILY_EVENTS
                                + ["--checkpoint-dir", ckpt_dir])
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ckpt_bytes = os.path.getsize(report.checkpoint_path)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, state = report.cfg, report.state
    steps = len(report.losses)
    cpu_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        with count_plain_calls() as power_launches:
            cpu = train.main(["--arch", arch, "--smoke", "--device", "cpu",
                              "--seq-len", "32"] + FAMILY_EVENTS
                             + ["--checkpoint-dir", cpu_dir])
    finally:
        shutil.rmtree(cpu_dir, ignore_errors=True)
    want = dict(family_launches(cfg, steps), **power_launches)
    family = {"TM": "moe", "TP": "ssm", "TH": "hybrid"}[tag]
    if cfg.family != family or steps != 4 or launches != want:
        raise AssertionError(f"{tag}: {cfg.family}, {steps} steps, kernel "
                             f"launches {launches}, expected {want}")
    if (report.plans, report.caps) != (cpu.plans, cpu.caps):
        raise AssertionError(f"{tag}: power plane on the card {report.plans}"
                             f" {report.caps}, on the CPU {cpu.plans} "
                             f"{cpu.caps}")
    if not (np.isfinite(report.losses).all()
            and np.isfinite(report.grad_norms).all()):
        raise AssertionError(f"{tag}: losses {report.losses}, grad norms "
                             f"{report.grad_norms}")

    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4096,
                           global_batch=4, seed=1, device=dev)
    b = data.next_batch()
    batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    opt = AdamW(learning_rate=3e-4, state_dtype=cfg.optimizer_state_dtype)
    step = make_train_step(cfg, opt)
    step_ms = [_event_ms(lambda: step(state, batch)) for _ in range(2)]
    traced = idle_share(lambda: step(state, batch))
    # The gradient check needs two float32 gradient trees beside the
    # parameters; AdamW's moments are done with.
    state.opt_state = None
    if tag == "TM":
        checked = dict(layer_grads_bitwise_rerun=moe_layer_rerun(
            cfg, state.params, dev))
    else:
        errs = _grads_against_plain(make_grads_fn(cfg), state.params, batch,
                                    1e-2, 5e-2, f"{tag} bf16, "
                                    f"{cfg.n_layers} layers")
        checked = dict(loss_rel_err_plain=errs[0],
                       worst_grad_rel_l2_plain=errs[1])
    trained = float(sum(report.tokens))
    info = dict(arch=arch, n_layers=cfg.n_layers,
                microbatches=cfg.microbatches, wall_s=wall,
                steps_s=report.seconds, trained_tokens=trained,
                tokens_per_s=trained / report.seconds,
                processed_tokens_per_s=4 * 4096 * steps / report.seconds,
                warm_step_ms=min(step_ms), warm_steps_ms=step_ms,
                peak_memory_gb=peak_gb, checkpoint_s=report.checkpoint_s,
                checkpoint_bytes=ckpt_bytes, losses=report.losses,
                grad_norms=report.grad_norms, plans=report.plans,
                caps=report.caps, params=cfg.param_count(),
                launches_power_plane=power_launches, **traced, **checked)
    log(f"path {tag}: {arch} at {cfg.n_layers} layers, {steps} steps of 4 x "
        f"4096 tokens in {cfg.microbatches} microbatches in "
        f"{report.seconds:.3f} s ({info['tokens_per_s']:.1f} trained tokens"
        f"/s; whole driver {wall:.3f} s, checkpoint "
        f"{report.checkpoint_s:.2f} s for {ckpt_bytes} bytes); warm steps "
        f"{step_ms} ms; a traced step {json.dumps(traced)}; peak "
        f"{peak_gb:.3f} GB; losses {report.losses}; grad "
        f"norms {report.grad_norms}; plans {report.plans}; caps "
        f"{report.caps}; launches {launches}")
    return launches, info


def moe_layer_rerun(cfg, params, dev) -> int:
    """Two backward passes of one OLMoE decoder layer (the path's first,
    in its bf16) at a TM microbatch's shape, 2 x 4096 tokens, on the same
    inputs and upstream gradients, without deterministic mode: every
    gradient, the input's and each weight's, must be equal bit for bit
    (the dispatch's gather sums a token's k rows in a fixed order, and no
    kernel of the layer adds with float atomics).  Returns the number of
    gradients compared."""
    from repro_torch.models import transformer as tfm

    blk = {name: w[0].detach().requires_grad_()
           for name, w in params["blocks"].items()}
    h = randn((2, 4096, cfg.d_model), torch.bfloat16, dev, 7
              ).requires_grad_()
    dh = randn((2, 4096, cfg.d_model), torch.bfloat16, dev, 8)
    positions = torch.arange(4096, device=dev)[None, :]
    leaves_in = [h] + list(blk.values())
    runs = []
    for _ in range(2):
        out, _, aux = tfm._attn_block(blk, h, cfg, positions, None)
        runs.append(torch.autograd.grad([out, aux], leaves_in,
                                        [dh, torch.ones_like(aux)]))
    names = ["h"] + list(blk)
    for name, a, b in zip(names, *runs):
        if not torch.equal(a, b):
            raise AssertionError(f"TM: one layer's gradient of {name} "
                                 f"differs between two backward passes")
    log(f"TM: one layer's backward at 2 x 4096 tokens twice: all "
        f"{len(names)} gradients equal bit for bit")
    return len(names)


def run_moe_train_f32_check(dev) -> dict:
    """OLMoE-1B-7B at full width and 4 layers in float32 (routing holds
    there, trap T4): one step of path TM's shape (4 x 4096 tokens in 2
    microbatches, C = 1280) through the kernels and through the plain
    versions, loss and every gradient within 1e-4 relative."""
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn

    cfg = dataclasses.replace(configs.get("olmoe_1b_7b"), n_layers=4,
                              param_dtype="float32")
    state = init_train_state(cfg, AdamW(learning_rate=1e-3),
                             torch.Generator(device=dev).manual_seed(0), dev)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=4096,
                           global_batch=4, seed=3, device=dev)
    b = data.next_batch()
    batch = {"tokens": b.tokens, "labels": b.labels, "weights": b.weights}
    loss_err, grad_err = _grads_against_plain(
        make_grads_fn(cfg), state.params, batch, 1e-4, 1e-4,
        "TM f32, 4 layers")
    return dict(n_layers=4, loss_rel_err=loss_err,
                worst_grad_rel_l2=grad_err)


# ------------------------------------------- every entry point, fresh thread
def replay_on_fresh_thread(module, name: str, outputs, run, what: str):
    """Runs ``run()`` (a wrapper's call) here, recording the last launch of
    ``module.name`` that it makes; then replays that launch on a new host
    thread whose first CUDA work it is (no PyTorch op runs there before
    it), into new outputs filled with NaN (or a value no output holds),
    and raises unless each of ``outputs`` equals the first launch's bit
    for bit."""
    import inspect
    real = getattr(module, name)
    sig = inspect.signature(real)
    calls = []

    def record(*args, **kwargs):
        calls.append(dict(sig.bind(*args, **kwargs).arguments))
        return real(*args, **kwargs)

    with mock.patch.object(module, name, record):
        run()
    torch.cuda.synchronize()
    if not calls:
        raise AssertionError(f"{what}: {name} never launched")
    args = calls[-1]
    want = {o: args[o].clone() for o in outputs}
    for o in outputs:
        t = args[o]
        fresh = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                    device=t.device)
        if t.dtype == torch.bool:
            fresh.copy_(~t)
        else:
            fresh.fill_(float("nan") if t.dtype.is_floating_point else -7)
        args[o] = fresh
    torch.cuda.synchronize()
    on_fresh_thread(lambda: real(**args))
    for o in outputs:
        if not torch.equal(args[o], want[o]):
            raise AssertionError(f"{what}: {o} from a fresh thread's launch "
                                 f"differs from this thread's")


def check_fresh_threads(dev) -> dict:
    """Every kernel entry point launched from a new host thread whose first
    CUDA work it is (autograd's worker thread can be such a thread), each
    bitwise equal to the same launch from this thread: K1, K2 and its
    occupancy query, K3, K4 and K5 in both regimes, K6, K7, and K8 and K8b
    in both regimes.  Returns ``{entry point: True}``."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import kernel_bwd as fa_bwd
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.moe_gmm import kernel as gmm_kernel
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.kernels.powercap import kernel as pc_kernel
    from repro_torch.kernels.powercap import ops as pc_ops
    from repro_torch.kernels.powercap.segments import segment_layout
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan import ops as ssd_ops

    done = {}
    x = kernel_inputs(2, 40, 10, seed=5, dev=dev, iters=100)
    cap, fl, ce, w, act = x["wf"]
    replay_on_fresh_thread(
        pc_kernel, "waterfill", ("out",),
        lambda: pc_ops.waterfill_dense(cap, fl, ce, w, 100, active=act),
        "powercap_waterfill")
    done["powercap_waterfill"] = True
    replay_on_fresh_thread(
        pc_kernel, "balance_caps", ("caps_out", "did_out", "rounds_out"),
        lambda: pc_ops.balance_caps(x["hosts"], x["caps"], x["dense"],
                                    x["cpu_res"], x["budget"], x["enabled"],
                                    ck.BalanceParams()),
        "powercap_balance_caps")
    done["powercap_balance_caps"] = True
    here = pc_kernel.max_active_clusters(10, dev.index or 0)
    pc_kernel.max_active_clusters.cache_clear()
    there = on_fresh_thread(lambda: pc_kernel.max_active_clusters(
        10, dev.index or 0))
    if there != here or not any(there):
        raise AssertionError(f"powercap_balance_max_active_clusters: a fresh "
                             f"thread's answer {there}, this thread's {here}")
    done["powercap_balance_max_active_clusters"] = True
    k3cap, k3fl, k3ce, k3w, seg, m = k3_inputs("ragged", dev)
    lay = segment_layout(seg, m, dev)
    replay_on_fresh_thread(
        pc_kernel, "waterfill_segmented", ("out",),
        lambda: pc_ops.waterfill_segmented(k3cap, k3fl, k3ce, k3w,
                                           layout=lay),
        "powercap_waterfill_segmented")
    done["powercap_waterfill_segmented"] = True

    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_tc")):
        q, k, v, do = attn_operands(2, 100, 164, 8, 2, 64, dtype, dev, 300)
        replay_on_fresh_thread(
            fa_kernel, "flash_fwd", ("out", "lse"),
            lambda: fa_ops.flash_attention(q, k, v, causal=False),
            f"flash_attention_fwd{suffix}")
        done[f"flash_attention_fwd{suffix}"] = True
        with torch.no_grad():
            out, lse = fa_ops.flash_attention(q, k, v, causal=True,
                                              q_offset=64)
        replay_on_fresh_thread(
            fa_bwd, "flash_bwd", ("dq", "dk", "dv"),
            lambda: fa_ops.flash_attention_bwd(q, k, v, out, lse, do,
                                               causal=True, q_offset=64),
            f"flash_attention_bwd_dkdv{suffix} and _dq{suffix}")
        done[f"flash_attention_bwd_dkdv{suffix}"] = True
        done[f"flash_attention_bwd_dq{suffix}"] = True

    dq = randn((4, 8, 64), torch.bfloat16, dev, 310)
    dk, dv = (randn((4, 300, 2, 64), torch.bfloat16, dev, 311 + i)
              for i in range(2))
    kv_len = torch.tensor([300, 1, 77, 256], dtype=torch.int32, device=dev)
    replay_on_fresh_thread(
        da_kernel, "decode", ("out",),
        lambda: da_ops.decode_attention(dq, dk, dv, kv_len),
        "decode_attention")
    done["decode_attention"] = True

    gx = randn((4, 128, 256), torch.bfloat16, dev, 320)
    gw = randn((4, 256, 128), torch.bfloat16, dev, 321)
    replay_on_fresh_thread(gmm_kernel, "gmm", ("out",),
                           lambda: gmm_ops.grouped_matmul(gx, gw), "moe_gmm")
    done["moe_gmm"] = True

    for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_tc")):
        sx, sdt, a_log, bm, cm = ssd_inputs(1, 512, 8, 64, 64, dtype, dev,
                                            330)
        sdt = sdt.float()
        ld = sdt * -torch.exp(a_log)
        replay_on_fresh_thread(
            ssd_kernel, "ssd_chunk", ("y", "contrib", "total"),
            lambda: ssd_ops._intra_chunk(sx, ld, sdt, bm, cm, 256),
            f"ssd_chunk{suffix}")
        done[f"ssd_chunk{suffix}"] = True
        args = k8b_operands(1, 512, 8, 64, 64, 256, dtype, dev, 340)
        replay_on_fresh_thread(
            ssd_kernel, "ssd_chunk_bwd", ("dx", "dld", "ddt", "db", "dc"),
            lambda: ssd_ops.ssd_chunk_bwd(*args), f"ssd_chunk_bwd{suffix}")
        done[f"ssd_chunk_bwd{suffix}"] = True
    log(f"fresh host threads: {len(done)} entry points launched from a new "
        f"thread, bitwise equal to this thread's: {sorted(done)}")
    return done


# ------------------------------------- paths I, Y, TI, TY: vlm and encdec
#: Whisper-tiny's encoder (1,500 frames) and its decoder's text context
#: (448 positions); InternVL2-26B's vision prefix (256 patches).
ENC_FRAMES, TEXT_CTX, N_PATCHES = 1500, 448, 256
#: Path I's serving driver: path S's replicas, requests, prompts, tokens
#: and cache at InternVL2-26B (text only, as the reference's driver
#: serves it), then each replica's batch again with a 256-patch prefix.
VLM_ARGV = ["--arch", "internvl2_26b"] + SERVE_ARGV[2:]
#: Path Y: 2 replicas of 8 requests, prompts of 4 tokens over 1,500
#: frames, 64 tokens in a 448-position cache.
Y_PROMPT, Y_STEPS = 4, 64
#: Paths TI and TY: 4 steps, 2 pods, the budget cut at step 1.  TI: 4 x
#: 4096 rows (256 patches and 3,840 tokens) in the config's 4
#: microbatches, 6 of InternVL2-26B's 48 layers; TY: Whisper-tiny whole,
#: 32 segments of 448 tokens over 1,500 frames.
TI_LAYERS, TI_BATCH, TI_ROWS = 6, 4, 4096
TY_BATCH = 32
FRONTEND_STEPS = 4


def attn_bounds(b, sq, skv, hq, hkv, d, causal, el) -> dict:
    """K4's and K5's bounds at a shape: the bytes (q, k, v and out, or
    those and dO, dq, dk and dv, with the float32 lse and D rows) and the
    operations, ``4 B Hq D`` a (query, key) pair for K4 and ``10 B Hq D``
    for K5, over the pairs the mask keeps."""
    pairs = sq * (sq + 1) // 2 if causal and sq == skv else sq * skv
    peak = PEAK_BF16_FLOPS if el == 2 else PEAK_FP32_FLOPS
    k4 = bound_ms(el * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
                  + 4 * b * hq * sq, 4 * b * hq * d * pairs, peak)
    k5 = bound_ms(el * (4 * b * sq * hq * d + 4 * b * skv * hkv * d)
                  + 8 * b * hq * sq, 10 * b * hq * d * pairs, peak)
    return {"k4": k4, "k5": k5}


def attn_shape_records(tag, cases, dev, with_k5: bool,
                       device: bool = False) -> list:
    """K4 (and, ``with_k5``, K5) against their plain versions at each of
    ``cases`` (``{case: (B, Sq, Skv, Hq, Hkv, D, causal)}``) in bf16 (the
    tensor cores, two launches bitwise equal) and float32 (the CUDA cores),
    each in the regime its plan must choose; the bf16 calls timed beside
    the plain versions and SDPA (its backward: forward and backward less
    forward), with their bounds; with ``device``, each bf16 kernel's
    device time too (``device_ms``; K5's two kernels summed).  Returns
    one record a kernel and case."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    records = []
    for i, (case, (b, sq, skv, hq, hkv, d, causal)) in enumerate(
            cases.items()):
        errs, plans = {}, {}
        for dtype in (torch.float32, torch.bfloat16):
            want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
            q, k, v, do = attn_operands(b, sq, skv, hq, hkv, d, dtype, dev,
                                        400 + 8 * i)
            plans["k4", dtype] = attn_plan(q, k, v, want=want,
                                           what=f"K4 {tag} {case}").regime
            errs["k4", dtype] = k4_case(q, k, v, causal, 0,
                                        f"K4 {tag} {case} {dtype}")
            if with_k5:
                plans["k5", dtype] = attn_plan(
                    q, k, v, do, want, f"K5 {tag} {case}").regime
                e, timed, _ = k5_case(q, k, v, do, causal, 0,
                                      f"K5 {tag} {case} {dtype}",
                                      bitwise=want == "tensor_core")
                errs["k5", dtype] = max(e.values())
        q, k, v, out, lse, do = timed if with_k5 else (q, k, v, None, None,
                                                       do)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        gqa = hq != hkv
        fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                      enable_gqa=gqa))
        bounds = attn_bounds(b, sq, skv, hq, hkv, d, causal, 2)
        k4_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=causal))
        k4_pms = time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, block_k=ops.BLOCK_K))
        dev_ms = {}
        if device:
            dev_ms["k4"] = device_ms(lambda: ops.flash_attention(
                q, k, v, causal=causal), "flash_fwd_tc")
        shape = f"{b}x{sq}x{skv}x{hq}x{hkv}x{d}"
        common = dict(route="cuda", case=case, causal=causal,
                      rtol=ATTN_TOL[torch.bfloat16],
                      atol_per_rms=ATTN_TOL[torch.bfloat16])
        records.append(dict(
            common, name=f"flash_attention {shape}",
            source=src + "flash_fwd_tc.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:83",
            regime=plans["k4", torch.bfloat16],
            max_abs_err=errs["k4", torch.bfloat16],
            float32_max_abs_err=errs["k4", torch.float32], ms=k4_ms,
            plain_ms=k4_pms, bound_ms=bounds["k4"][0],
            bound_by=bounds["k4"][1], library_ms=fwd_ms,
            **({"device_ms": dev_ms["k4"]} if device else {})))
        line = (f"{tag}: K4 {case} {shape} ({plans['k4', torch.bfloat16]}) "
                f"err {errs['k4', torch.bfloat16]:.3e} (float32 "
                f"{errs['k4', torch.float32]:.3e}) {k4_ms:.4f} ms (plain "
                f"{k4_pms:.3f} ms, SDPA {fwd_ms:.4f} ms, bound "
                f"{bounds['k4'][0]:.4f} ms)")
        if with_k5:
            dot = do.transpose(1, 2)
            both_ms = time_ms(lambda: torch.autograd.grad(
                sdpa(qt, kt, vt, is_causal=causal, enable_gqa=gqa),
                (qt, kt, vt), dot))
            k5_ms = time_ms(lambda: ops.flash_attention_bwd(
                q, k, v, out, lse, do, causal=causal))
            k5_pms = time_ms(lambda: ref.flash_attention_bwd_ref(
                q, k, v, out, lse, do, causal=causal, block_q=ops.BLOCK_Q,
                block_k=ops.BLOCK_K))
            if device:
                parts = [device_ms(lambda: ops.flash_attention_bwd(
                    q, k, v, out, lse, do, causal=causal), name)
                    for name in ("flash_bwd_dkdv_tc", "flash_bwd_dq_tc")]
                dev_ms["k5"] = None if None in parts else sum(parts)
            records.append(dict(
                common, name=f"flash_attention_bwd {shape}",
                source=src + "flash_bwd_tc.cu",
                replaces="src/repro/kernels/flash_attention/kernel_bwd.py"
                         ":125",
                regime=plans["k5", torch.bfloat16],
                max_abs_err=errs["k5", torch.bfloat16],
                float32_max_abs_err=errs["k5", torch.float32], ms=k5_ms,
                plain_ms=k5_pms, bound_ms=bounds["k5"][0],
                bound_by=bounds["k5"][1], library_ms=both_ms - fwd_ms,
                **({"device_ms": dev_ms["k5"]} if device else {})))
            line += (f"; K5 err {errs['k5', torch.bfloat16]:.3e} (float32 "
                     f"{errs['k5', torch.float32]:.3e}) {k5_ms:.4f} ms "
                     f"(plain {k5_pms:.3f} ms, SDPA backward "
                     f"{both_ms - fwd_ms:.4f} ms, bound "
                     f"{bounds['k5'][0]:.4f} ms)")
        if device:
            line += "; device " + ", ".join(
                f"{k.upper()} {fmt_ms(v)}" for k, v in dev_ms.items())
        log(line)
        del q, k, v, do, out, lse, qt, kt, vt
    return records


def k6_shape_record(tag, b, s, hq, hkv, d, kv_len, dev, seed,
                    device: bool = False) -> dict:
    """K6 against its plain version over a cache of ``s`` positions with
    ``kv_len`` live on every row, in bf16 and float32 (two launches
    bitwise equal each), timed beside its plain version and SDPA in
    bf16, with its bound; with ``device``, its device time too (the
    partials and the combine summed)."""
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((b, hq, d), dtype, dev, seed)
        k, v = (randn((b, s, hkv, d), dtype, dev, seed + 1 + i)
                for i in range(2))
        lens = torch.full((b,), kv_len, dtype=torch.int32, device=dev)
        errs[dtype], p = k6_case(q, k, v, lens, f"K6 {tag} {dtype}")
    times = time_k6(q, k, v, lens)
    if device:
        from repro_torch.kernels.decode_attention import ops
        parts = [device_ms(lambda: ops.decode_attention(q, k, v, lens), n)
                 for n in ("decode_partials", "decode_combine")]
        times["device_ms"] = None if None in parts else sum(parts)
        log(f"{tag}: K6 device {fmt_ms(times['device_ms'])}")
    log(f"{tag}: K6 {b}x{s}x{hq}x{hkv}x{d} kv_len {kv_len} (split "
        f"{p.split}) err {errs[torch.bfloat16]:.3e} (float32 "
        f"{errs[torch.float32]:.3e}) {times['ms']:.4f} ms (plain "
        f"{times['plain_ms']:.3f} ms, SDPA {times['library_ms']:.4f} ms, "
        f"bound {times['bound_ms']:.5f} ms)")
    return k6_record((b, s, hq, d), errs[torch.bfloat16],
                     errs[torch.float32], p, times, kv_len=kv_len)


def check_frontend_attention(dev) -> dict:
    """K4, K5 and K6 at the four new paths' shapes, held and timed as
    :func:`attn_shape_records` and :func:`k6_shape_record` hold them: I's
    prefill (8 x 768 rows, 48/8 heads of 128, causal) and decode step
    (a 1024-position cache, 784 live); TI's microbatch (1 x 4096, causal,
    K4 and K5); Y's encoder (8 x 1500 frames, 6/6 heads of 64, non-causal:
    1,500 = 11 x 128 + 92 keys, a ragged last tile) and its prefill's
    cross attention (4 rows over 1,500), and its decode step's cross
    attention on K6 (kv_len 1,500); TY's encoder (32 x 1500) and cross
    attention (32 x 448 rows over 1,500 keys), K4 and K5.  Returns the
    records by path."""
    seq = N_PATCHES + 512
    return {
        "I": attn_shape_records("I", {"prefill": (8, seq, seq, 48, 8, 128,
                                                  True)}, dev, False)
        + [k6_shape_record("I", 8, 1024, 48, 8, 128, seq + 16, dev, 500)],
        "TI": attn_shape_records("TI", {"layer": (1, TI_ROWS, TI_ROWS, 48,
                                                  8, 128, True)}, dev, True),
        "Y": attn_shape_records("Y", {
            "encoder": (8, ENC_FRAMES, ENC_FRAMES, 6, 6, 64, False),
            "cross_prefill": (8, Y_PROMPT, ENC_FRAMES, 6, 6, 64, False)},
            dev, False)
        + [k6_shape_record("Y", 8, ENC_FRAMES, 6, 6, 64, ENC_FRAMES, dev,
                           510)],
        "TY": attn_shape_records("TY", {
            "encoder": (TY_BATCH, ENC_FRAMES, ENC_FRAMES, 6, 6, 64, False),
            "cross": (TY_BATCH, TEXT_CTX, ENC_FRAMES, 6, 6, 64, False)},
            dev, True)}


def serve_launches(cfg, n_rep: int, prompt_len: int, steps: int) -> dict:
    """The model kernels' launches of ``n_rep`` batches of ``generate``:
    a decoder layer's prefill runs K4 and its decode step K6; an
    encoder-decoder's prefill runs K4 in each encoder layer and twice in
    each decoder layer (self and cross attention), and its decode step the
    encoder again (K4 a layer) and K6 twice a decoder layer."""
    n = dict.fromkeys(_model_wrappers(), 0)
    if cfg.family == "encdec":
        n["flash_attention"] = n_rep * (cfg.enc_layers + 2 * cfg.n_layers
                                        + (steps - 1) * cfg.enc_layers)
        n["decode_attention"] = n_rep * (steps - 1) * 2 * cfg.n_layers
    else:
        n["flash_attention"] = n_rep * cfg.n_layers
        n["decode_attention"] = n_rep * (steps - 1) * cfg.n_layers
    return n


def frontend_extras(cfg, n: int, text_len: int, dev, seed: int) -> dict:
    """A prefill's frontend stand-ins for ``n`` requests (float32 patch or
    frame embeddings, 0.1 a standard normal), drawn from ``seed`` through
    ``launch.inputs``."""
    from repro_torch.launch import inputs
    from repro_torch.models.config import ShapeConfig

    prefix = cfg.n_prefix_embeds if cfg.family == "vlm" else 0
    _, extras = inputs.prefill_specs(
        cfg, ShapeConfig("serve", "prefill", text_len + prefix, n))
    g = torch.Generator(device=dev).manual_seed(seed)
    return {k: inputs.draw(spec, g) for k, spec in extras.items()}


def warm_serve_ms(cfg, params, prompts, extras, steps, max_len, reps):
    """Prefill and decode-step ms of one warm batch (CUDA events, the
    median of ``reps``)."""
    from repro_torch.runtime.serve_loop import (make_decode_step,
                                                make_prefill_step)
    prefill = make_prefill_step(cfg, max_len)
    decode = make_decode_step(cfg)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    prefill_ms, step_ms = [], []
    for _ in range(reps):
        start.record()
        lg, state = prefill(params, prompts, extras)
        mid.record()
        tok = lg.argmax(-1)
        for _ in range(steps - 1):
            lg, state = decode(params, state, tok)
            tok = lg.argmax(-1)
        end.record()
        end.synchronize()
        prefill_ms.append(start.elapsed_time(mid))
        step_ms.append(mid.elapsed_time(end) / (steps - 1))
    return statistics.median(prefill_ms), statistics.median(step_ms)


@contextlib.contextmanager
def eager_decode():
    """``generate``'s decode steps run eagerly on the card, as they run
    on the CPU and under a bound sharding context (the comparison runs
    and the recorded routes only)."""
    from repro_torch.runtime import decode_graph

    with mock.patch.object(decode_graph, "takes_graph",
                           lambda state, steps: False):
        yield


def check_decode_graph(tag, cfg, params, prompts, extras, steps, max_len
                       ) -> dict:
    """The graph phase: ``generate``'s replayed decode steps against the
    eager ones (:func:`eager_decode`) on one replica's batch, greedy
    tokens and logits and teacher-forced logits bitwise equal; then one
    warm batch's capture and instantiation ms, its replayed steps' ms
    (CUDA events around each replay, the median) and the eager step's
    (:func:`warm_serve_ms`)."""
    from repro_torch.runtime import decode_graph
    from repro_torch.runtime.serve_loop import generate, make_prefill_step

    made = []

    class Recorded(decode_graph.DecodeGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    with mock.patch.object(decode_graph, "DecodeGraph", Recorded):
        toks, logits = generate(cfg, params, prompts, steps, max_len,
                                extras=extras)
        _, f_logits = generate(cfg, params, prompts, steps, max_len,
                               forced=toks, extras=extras)
    with eager_decode():
        e_toks, e_logits = generate(cfg, params, prompts, steps, max_len,
                                    extras=extras)
        _, ef_logits = generate(cfg, params, prompts, steps, max_len,
                                forced=toks, extras=extras)
    equal = dict(tokens=torch.equal(toks, e_toks),
                 logits=torch.equal(logits, e_logits),
                 forced_logits=torch.equal(f_logits, ef_logits))
    if len(made) != 2 or not all(equal.values()):
        raise AssertionError(f"{tag} graph: {len(made)} captures, bitwise "
                             f"equal to the eager steps {equal}")
    del toks, logits, f_logits, e_toks, e_logits, ef_logits

    prefill = make_prefill_step(cfg, max_len)
    lg, state = prefill(params, prompts, extras)
    torch.cuda.synchronize()
    graph = decode_graph.DecodeGraph(cfg, params, state, prompts.shape[1],
                                     lg.argmax(-1), True)
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
             for _ in range(steps - 1)]
    for start, end in pairs:
        start.record()
        graph.replay(state)
        end.record()
    torch.cuda.synchronize()
    replay_ms = statistics.median(a.elapsed_time(b) for a, b in pairs)
    capture_ms, inst_ms = graph.capture_s * 1e3, graph.instantiate_s * 1e3
    del graph, state, lg
    _, eager_ms = warm_serve_ms(cfg, params, prompts, extras, steps,
                                max_len, 1)
    out = dict(bitwise_equal=True, capture_ms=capture_ms,
               instantiate_ms=inst_ms, replay_step_ms=replay_ms,
               eager_step_ms=eager_ms)
    log(f"path {tag} graph: replayed decode bitwise equal to the eager "
        f"steps (greedy tokens and logits, teacher-forced logits); "
        f"capture {capture_ms:.1f} ms, instantiation {inst_ms:.1f} ms, "
        f"replayed step {replay_ms:.3f} ms, eager step {eager_ms:.3f} ms "
        f"(one batch of {prompts.shape[0]})")
    return out


def hold_cap_event(tag, report, n_requests: int, n_rep: int) -> dict:
    """The card's cap event (``report``'s ``routing_after``,
    ``caps_after``, ``notes``, ``cap_changes`` and ``migrations``) against
    the same event's CPU run on a new fleet of ``n_rep`` replicas; returns
    the K1-K3 launches that run's plain calls make (K2 once)."""
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.launch import serve
    snap, router = serve.make_fleet(H100_HOST, n_rep)
    with count_plain_calls() as power_launches:
        routing, caps, result = serve.power_event(snap, router, n_requests,
                                                  "cpu")
    got = (list(report.routing_after.items()), report.caps_after,
           list(report.notes), report.cap_changes, report.migrations)
    cpu = (list(routing.items()), caps, list(result.notes),
           result.cap_changes, result.migrations)
    if got != cpu or power_launches["balance_caps"] != 1:
        raise AssertionError(f"{tag}: cap event on the card {got}, on the "
                             f"CPU {cpu} ({power_launches})")
    return power_launches


def teacher_forced(tag, cfg, params, prompts, toks, logits, steps, max_len,
                   extras) -> tuple[float, float]:
    """One replica's batch fed back through the plain versions on the
    card: logits within 2e-2 relative L2 (path S's bar); returns the error
    and the share of argmax equal to the kernels' tokens."""
    from repro_torch.runtime.serve_loop import generate
    with plain_attention():
        _, plain_logits = generate(cfg, params, prompts, steps, max_len,
                                   forced=toks, extras=extras)
    err = rel_l2(logits, plain_logits)
    if not err <= 2e-2:
        raise AssertionError(f"{tag}: teacher-forced logits {err:.3e} "
                             f"relative L2 from the plain versions (bound "
                             f"2e-2)")
    return err, float((plain_logits.argmax(-1) == toks).float().mean())


def run_vlm_serving_path(dev) -> tuple[dict, dict]:
    """Path I: ``launch.serve.main`` at InternVL2-26B's full width and
    depth in bf16 (text only, as the reference's driver serves a VLM),
    then each replica's batch through ``generate`` again with a 256-patch
    prefix; the launch counts of both together exact, the cap event held
    against its CPU run, one replica's prefixed batch against the plain
    versions; then warm prefill and decode-step times with the prefix."""
    from repro_torch.launch import serve
    from repro_torch.runtime.serve_loop import generate

    steps, max_len, prompt_len = 32, 1024, 512
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    report = serve.main(VLM_ARGV)
    wall = time.perf_counter() - t0
    cfg, params = report.cfg, report.params
    n_rep = len(report.routing)
    batches = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i, (rep, (prompts, _, _)) in enumerate(report.batches.items()):
        extras = frontend_extras(cfg, prompts.shape[0], prompt_len, dev,
                                 20 + i)
        toks, logits = generate(cfg, params, prompts, steps, max_len,
                                extras=extras)
        batches[rep] = (prompts, extras, toks, logits)
    torch.cuda.synchronize()
    prefix_s = time.perf_counter() - t1
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    power = hold_cap_event("I", report, 16, n_rep)
    text = serve_launches(cfg, n_rep, prompt_len, steps)
    want = {k: 2 * n for k, n in text.items()}
    want.update(power)
    if (cfg.family != "vlm" or launches != want
            or report.routing != {"rep0": 8, "rep1": 8}):
        raise AssertionError(f"I: {cfg.family}, routing {report.routing}, "
                             f"kernel launches {launches}, expected {want}")
    tokens = sum(t.numel() for _, _, t, _ in batches.values())
    for rep, (_, _, toks, logits) in batches.items():
        if toks.shape != (8, steps) or not torch.isfinite(logits).all():
            raise AssertionError(f"I {rep}: tokens {tuple(toks.shape)} or "
                                 f"non-finite logits")
    prompts, extras, toks, logits = batches["rep0"]
    err, same = teacher_forced("I", cfg, params, prompts, toks, logits,
                               steps, max_len, extras)
    prefill_ms, step_ms = warm_serve_ms(cfg, params, prompts, extras, steps,
                                        max_len, 2)
    weights_gb = sum(t.numel() * t.element_size() for grp in params.values()
                     for t in grp.values()) / 1e9
    info = dict(arch="internvl2_26b", wall_s=wall,
                text_decode_s=report.seconds, text_tokens=report.tokens,
                text_tokens_per_s=report.tokens / report.seconds,
                prefix_decode_s=prefix_s, tokens=tokens,
                tokens_per_s=tokens / prefix_s, prefill_ms=prefill_ms,
                decode_step_ms=step_ms, weights_gb=weights_gb,
                peak_memory_gb=peak_gb, teacher_forced_rel_l2=err,
                plain_argmax_equal=same, routing=report.routing,
                routing_after=report.routing_after,
                caps_after=report.caps_after, notes=report.notes,
                prompt_len=prompt_len, patches=N_PATCHES, steps=steps,
                params=cfg.param_count())
    info["decode_graph"] = check_decode_graph("I", cfg, params, prompts,
                                              extras, steps, max_len)
    log(f"path I: text only {report.tokens} tokens in {report.seconds:.3f} s "
        f"({info['text_tokens_per_s']:.1f} tokens/s; whole driver "
        f"{wall:.3f} s); with the 256-patch prefix {tokens} tokens in "
        f"{prefix_s:.3f} s ({info['tokens_per_s']:.1f} tokens/s); prefill "
        f"{prefill_ms:.2f} ms, decode step {step_ms:.2f} ms (warm, one batch "
        f"of 8, 256 + 512 rows); weights {weights_gb:.3f} GB, peak "
        f"{peak_gb:.3f} GB; teacher-forced logits {err:.3e} relative L2 "
        f"(argmax equal {same:.3f}); launches {launches}; cap event "
        f"{report.caps_after} W, {report.routing_after}")
    del report, params, batches
    return launches, info


def run_frontend_f32_check(arch: str, n_layers, prompt_len: int,
                           steps: int, max_len: int, dev) -> dict:
    """``arch`` at full width in float32 (``n_layers`` layers, None: all)
    on one batch of 8 with its frontend stand-ins: greedy tokens through
    the kernels identical to the plain versions', logits within 1e-4
    relative L2."""
    from repro_torch import configs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    cfg = configs.get(arch)
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                              param_dtype="float32")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    prompts = torch.randint(0, cfg.vocab_size, (8, prompt_len), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    extras = frontend_extras(cfg, 8, prompt_len, dev, 2)
    toks, logits = generate(cfg, params, prompts, steps, max_len,
                            extras=extras)
    with plain_attention():
        ptoks, plogits = generate(cfg, params, prompts, steps, max_len,
                                  extras=extras)
    err = rel_l2(logits, plogits)
    if not torch.equal(toks, ptoks) or not err <= 1e-4:
        raise AssertionError(f"{arch} f32: tokens equal "
                             f"{torch.equal(toks, ptoks)}, logits {err:.3e} "
                             f"relative L2 from the plain versions (bound "
                             f"1e-4)")
    log(f"{arch} f32, {cfg.n_layers} layers: tokens identical, logits "
        f"{err:.3e} relative L2")
    return dict(n_layers=cfg.n_layers, rel_l2=err, tokens_identical=True)


def run_encdec_serving_path(dev) -> tuple[dict, dict]:
    """Path Y: Whisper-tiny whole in bf16 behind ``make_fleet``'s router:
    ``launch.serve.main`` first (it raises for want of frames, as the
    reference's driver does), then each replica's batch through
    ``generate`` with 1,500 frames a request, the cap event through
    ``power_event``; launch counts exact, the cap event held against its
    CPU run, one replica's batch against the plain versions; then warm
    prefill and decode-step times."""
    from repro_torch import configs
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.serve_loop import generate

    try:
        serve.main(["--arch", "whisper_tiny", "--requests", "16"])
    except ValueError as exc:
        if "frames" not in str(exc):
            raise
        refused = str(exc)
    else:
        raise AssertionError("Y: launch.serve served whisper_tiny without "
                             "frames")
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = configs.get("whisper_tiny")
    params = tfm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    snap, router = serve.make_fleet(H100_HOST, 2)
    routing = serve._count(router.route(16))
    batches = {}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i, (rep, n) in enumerate(routing.items()):
        prompts = torch.randint(0, cfg.vocab_size, (n, Y_PROMPT), device=dev,
                                generator=torch.Generator(device=dev)
                                .manual_seed(1))
        extras = frontend_extras(cfg, n, Y_PROMPT, dev, 30 + i)
        toks, logits = generate(cfg, params, prompts, Y_STEPS, TEXT_CTX,
                                extras=extras)
        batches[rep] = (prompts, extras, toks, logits)
        for _ in range(n):
            router.complete(rep)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    routing_after, caps_after, result = serve.power_event(snap, router, 16,
                                                          dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    power = hold_cap_event("Y", SimpleNamespace(
        routing_after=routing_after, caps_after=caps_after,
        notes=result.notes, cap_changes=result.cap_changes,
        migrations=result.migrations), 16, 2)
    want = dict(serve_launches(cfg, 2, Y_PROMPT, Y_STEPS), **power)
    if launches != want or routing != {"rep0": 8, "rep1": 8}:
        raise AssertionError(f"Y: routing {routing}, kernel launches "
                             f"{launches}, expected {want}")
    tokens = sum(t.numel() for _, _, t, _ in batches.values())
    for rep, (_, _, toks, logits) in batches.items():
        if toks.shape != (8, Y_STEPS) or not torch.isfinite(logits).all():
            raise AssertionError(f"Y {rep}: tokens {tuple(toks.shape)} or "
                                 f"non-finite logits")
    prompts, extras, toks, logits = batches["rep0"]
    err, same = teacher_forced("Y", cfg, params, prompts, toks, logits,
                               Y_STEPS, TEXT_CTX, extras)
    prefill_ms, step_ms = warm_serve_ms(cfg, params, prompts, extras,
                                        Y_STEPS, TEXT_CTX, 3)
    info = dict(arch="whisper_tiny", wall_s=wall, decode_s=decode_s,
                tokens=tokens, tokens_per_s=tokens / decode_s,
                prefill_ms=prefill_ms, decode_step_ms=step_ms,
                peak_memory_gb=peak_gb, teacher_forced_rel_l2=err,
                plain_argmax_equal=same, routing=routing,
                routing_after=routing_after, caps_after=caps_after,
                notes=list(result.notes), prompt_len=Y_PROMPT,
                frames=ENC_FRAMES, steps=Y_STEPS, max_len=TEXT_CTX,
                params=cfg.param_count(), driver_refused=refused)
    info["decode_graph"] = check_decode_graph("Y", cfg, params, prompts,
                                              extras, Y_STEPS, TEXT_CTX)
    log(f"path Y: {tokens} tokens in {decode_s:.3f} s "
        f"({info['tokens_per_s']:.1f} tokens/s; whole path {wall:.3f} s); "
        f"prefill {prefill_ms:.2f} ms, decode step {step_ms:.2f} ms (warm, "
        f"one batch of 8 over 1500 frames); peak {peak_gb:.3f} GB; "
        f"teacher-forced logits {err:.3e} relative L2 (argmax equal "
        f"{same:.3f}); launches {launches}; cap event {caps_after} W, "
        f"{routing_after}; launch.serve without frames: {refused}")
    return launches, info


def frontend_training(cfg, shape, steps: int, dev, seed: int = 0,
                      peak_lr: float = 3e-3):
    """``steps`` training steps of ``cfg`` on batches of ``shape`` with the
    frontend's stand-ins (``launch.inputs``), under ``launch.train``'s
    power plane: 2 pods at 85% of peak, the budget cut at step 1 (20% of
    the budget lost and pod0 capped hard, then one manager invocation and
    a new batch plan), as ``launch.train.main`` runs it (its cosine
    schedule to ``peak_lr``, the driver's default ``--lr``).  Returns
    ``(state, plans, caps, losses, tokens, grad_norms, seconds, last
    batch)``."""
    from repro_torch.core.power_model import H100_HOST
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import inputs, train
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.runtime.power_integration import PowerAwareBatchScheduler
    from repro_torch.runtime.train_loop import init_train_state, make_train_step

    opt = AdamW(learning_rate=cosine_schedule(peak_lr, 10, steps),
                state_dtype=cfg.optimizer_state_dtype)
    state = init_train_state(cfg, opt,
                             torch.Generator(device=dev).manual_seed(seed),
                             dev)
    specs = inputs.train_batch_specs(cfg, shape)
    data = SyntheticTokens(vocab_size=cfg.vocab_size,
                           seq_len=specs["tokens"].shape[1],
                           global_batch=shape.global_batch, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    snap, manager = train.build_power_plane(2, H100_HOST,
                                            0.85 * H100_HOST.power_peak, dev)
    scheduler = PowerAwareBatchScheduler(shape.global_batch,
                                         [["pod0"], ["pod1"]])
    step_fn = make_train_step(cfg, opt)
    plan = scheduler.plan(snap)
    plans, caps, metrics_log = [(0, plan.examples_per_pod.tolist())], [], []
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(steps):
        if step == 1:
            snap.power_budget *= 0.8
            snap.hosts["pod0"].power_cap *= 0.6
            snap = manager.run_invocation(snap).snapshot
            plan = scheduler.plan(snap)
            plans.append((step, plan.examples_per_pod.tolist()))
            caps.append((step, "budget cut", train._caps(snap)))
        b = data.next_batch()
        batch = {"tokens": b.tokens, "labels": b.labels,
                 "weights": b.weights}
        batch.update({k: inputs.draw(spec, g) for k, spec in specs.items()
                      if k not in batch})
        batch = scheduler.apply(batch, plan)
        state, metrics = step_fn(state, batch)
        metrics_log.append(metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    read = {k: [float(m[k]) for m in metrics_log]
            for k in ("loss", "tokens", "grad_norm")}
    return (state, plans, caps, read["loss"], read["tokens"],
            read["grad_norm"], seconds, batch, step_fn)


def frontend_path(tag: str):
    """``(arch, config, batch shape)`` of path TI or TY."""
    from repro_torch import configs
    from repro_torch.models.config import ShapeConfig
    if tag == "TI":
        arch = "internvl2_26b"
        return (arch, dataclasses.replace(configs.get(arch),
                                          n_layers=TI_LAYERS),
                ShapeConfig(tag, "train", TI_ROWS, TI_BATCH))
    arch = "whisper_tiny"
    return (arch, configs.get(arch),
            ShapeConfig(tag, "train", TEXT_CTX, TY_BATCH))


def run_frontend_training_path(tag: str, dev) -> tuple[dict, dict]:
    """Path TI (InternVL2-26B, 6 of 48 layers, 4 x 4096 rows: 256 patches
    and 3,840 tokens) or TY (Whisper-tiny whole, 32 x 448 tokens over
    1,500 frames) through :func:`frontend_training` on the card, in bf16;
    launch counts exact (a layer a microbatch, under remat: K4 twice and
    K5 once an attention), the power plane held against the same events'
    CPU run at the smoke size (the same global batch, 32 rows), finite
    losses and gradient norms, one
    batch's loss and every gradient (``vision_proj`` too) against the
    plain versions on the card (loss 1e-2 relative, each gradient 5e-2
    relative L2, path T's bounds; TY's at its initial parameters, at its
    trained state K4 launch by launch and K5 against its plain version fed
    K4's O, and float32 after the same 4 steps within 1e-4); two warm
    steps timed and a third traced (the device's idle share)."""
    from repro_torch import configs
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.train_loop import init_train_state, make_grads_fn

    arch, cfg, shape = frontend_path(tag)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (state, plans, caps, losses, tokens, gnorms, seconds, batch,
     step_fn) = frontend_training(cfg, shape, FRONTEND_STEPS, dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scfg = configs.get_smoke(arch)
    with count_plain_calls() as power_launches:
        cpu = frontend_training(
            scfg, ShapeConfig(tag, "train", 32, shape.global_batch),
            FRONTEND_STEPS, torch.device("cpu"))
    mb = max(cfg.microbatches, 1) * FRONTEND_STEPS
    attn = cfg.n_layers * (2 if cfg.family == "encdec" else 1) + (
        cfg.enc_layers if cfg.family == "encdec" else 0)
    want = dict.fromkeys(_model_wrappers(), 0)
    want.update(flash_attention=2 * attn * mb, flash_attention_bwd=attn * mb,
                **power_launches)
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"{want}")
    if (plans, caps) != (cpu[1], cpu[2]):
        raise AssertionError(f"{tag}: power plane on the card {plans} "
                             f"{caps}, on the CPU {cpu[1]} {cpu[2]}")
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        raise AssertionError(f"{tag}: losses {losses}, grad norms {gnorms}")
    step_ms = [_event_ms(lambda: step_fn(state, batch)) for _ in range(2)]
    traced = idle_share(lambda: step_fn(state, batch))
    state.opt_state = None
    held = state.params
    if tag == "TY":
        # Training shuts TY's cross attention (random frames say nothing
        # of random labels): after the path's 7 steps its leaves' gradients
        # are about 2,000x smaller than at init, and the bf16 rounding of
        # two forwards' O, through D = rowsum(dO O), moves them by up to
        # 26% between the kernels and the plain versions.  So at the
        # trained state K4 is held launch by launch against its plain
        # version, and K5 through every gradient against its plain version
        # fed K4's O (path T's bounds); the whole plain route's loss is
        # gated there and its gradients printed.  The whole plain route is
        # gated in bf16 at the initial parameters, and in float32 after the
        # path's 4 steps (1e-4, as the other float32 checks).
        k4_errs = []
        given = _grads_against_plain(
            make_grads_fn(cfg), held, batch, 1e-2, 5e-2,
            "TY bf16, trained state, K5 against its plain version given "
            "K4's O", plain=plain_k5_given_k4(k4_errs, "TY trained"))
        whole = _grads_against_plain(
            make_grads_fn(cfg), held, batch, 1e-2, float("inf"),
            "TY bf16, trained state, the whole plain route (loss gated, "
            "gradients printed)")
        log(f"TY trained state: {len(k4_errs)} K4 launches within bf16's "
            f"bound of the plain forward, worst max abs err "
            f"{max(k4_errs)}")
        trained_state = dict(
            k5_given_k4_loss_rel_err=given[0],
            k5_given_k4_worst_grad_rel_l2=given[1],
            k4_launches_held=len(k4_errs), k4_max_abs_err=max(k4_errs),
            whole_plain_loss_rel_err=whole[0],
            whole_plain_worst_grad_rel_l2=whole[1])
        held = init_train_state(cfg, AdamW(learning_rate=1e-3),
                                torch.Generator(device=dev).manual_seed(0),
                                dev).params
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        state32 = frontend_training(cfg32, shape, FRONTEND_STEPS, dev)[0]
        state32.opt_state = None
        f32 = _grads_against_plain(make_grads_fn(cfg32), state32.params,
                                   batch, 1e-4, 1e-4,
                                   "TY float32 after 4 steps")
        del state32
    loss_err, grad_err = _grads_against_plain(
        make_grads_fn(cfg), held, batch, 1e-2, 5e-2,
        f"{tag} bf16, {cfg.n_layers} layers"
        + (", initial parameters" if tag == "TY" else ""))
    trained = float(sum(tokens))
    rows = shape.global_batch * shape.seq_len
    info = dict(arch=arch, n_layers=cfg.n_layers, enc_layers=cfg.enc_layers,
                microbatches=cfg.microbatches, wall_s=wall, steps_s=seconds,
                trained_tokens=trained, tokens_per_s=trained / seconds,
                processed_rows_per_s=rows * FRONTEND_STEPS / seconds,
                warm_step_ms=min(step_ms), warm_steps_ms=step_ms,
                peak_memory_gb=peak_gb, losses=losses, grad_norms=gnorms,
                plans=plans, caps=caps, params=cfg.param_count(),
                loss_rel_err_plain=loss_err, worst_grad_rel_l2_plain=grad_err,
                launches_power_plane=power_launches, **traced)
    if tag == "TY":
        info["float32_trained"] = dict(loss_rel_err_plain=f32[0],
                                       worst_grad_rel_l2_plain=f32[1])
        info["bf16_trained"] = trained_state
    log(f"path {tag}: {arch} at {cfg.n_layers} layers, {FRONTEND_STEPS} "
        f"steps of {shape.global_batch} x {shape.seq_len} in "
        f"{cfg.microbatches} microbatches in {seconds:.3f} s "
        f"({info['tokens_per_s']:.1f} trained tokens/s; whole path "
        f"{wall:.3f} s); warm steps {step_ms} ms; a traced step "
        f"{json.dumps(traced)}; peak {peak_gb:.3f} GB; losses {losses}; "
        f"grad norms {gnorms}; plans {plans}; caps {caps}; launches "
        f"{launches}")
    del state, batch, step_fn
    return launches, info


def run_path(tag, specs, policies):
    """One grid through ``run_sweep_batched`` (the exact pack) on the card,
    with the launch counts of exactly that run."""
    from repro_torch.sim.batch import _drs_schedule
    from repro_torch.sim.sweep import build_sweep, run_sweep_batched

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_sweep_batched(specs, policies)
    wall = time.perf_counter() - t0
    launches = read_launches()
    _, _, cfg = build_sweep(specs[0], policies[0])
    ts, drs = _drs_schedule(cfg)
    want = dict(no_model_launches(), waterfill_dense=ts.shape[0],
                balance_caps=int(drs.sum()), waterfill_segmented=0)
    if launches != want:
        raise AssertionError(f"{tag}: kernel launches {launches}, expected "
                             f"one per tick and one per DRS invocation "
                             f"{want}")
    n = len(specs) * len(policies)
    engine_s = sum(r.wall_s for per in res.values() for r in per.values())
    log(f"path {tag}: {n} cells, {ts.shape[0]} ticks, {int(drs.sum())} DRS "
        f"invocations: wall {wall:.3f} s ({n / wall:.2f} cells/s, "
        f"{ts.shape[0] / wall:.1f} ticks/s); engine {engine_s:.3f} s "
        f"({n / engine_s:.2f} cells/s); launches {launches}")
    return res, launches, dict(wall_s=wall, engine_s=engine_s, cells=n,
                               ticks=int(ts.shape[0]))


def run_vector_path(policies):
    """Path V through ``run_sweep(..., engine="vector")`` on the card, with
    the launch counts of exactly that run; then the same cells on the CPU
    and on the batched engine, both held against it."""
    from repro_torch.sim.batch import _drs_schedule
    from repro_torch.sim.sweep import (build_sweep, run_sweep,
                                       run_sweep_batched, scale_ladder)

    specs = scale_ladder(sizes=(1000,), spike="burst", duration_s=600.0)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(specs, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    keys = [(s.name, p) for s in specs for p in policies]
    _, _, cfg = build_sweep(specs[0], policies[0])
    ts, drs = _drs_schedule(cfg)
    ticks, invocations = int(ts.shape[0]), int(drs.sum())
    cpc_invocations = invocations * sum(p == "cpc" for _, p in keys)
    cpu = run_sweep(specs, policies, engine="vector", device="cpu")
    compare("V vs CPU", gpu, cpu, keys)
    # Every cpc invocation of this path commits a balance (the burst is on
    # at 300 s): the CPU run's cap changes show it, and each committed
    # balance's note waterfills twice more (imbalance before and after).
    for name, p in keys:
        if p == "cpc" and cpu[name][p].cap_changes <= 0:
            raise AssertionError(f"V {name}/cpc: no cap change on the CPU")
    want = dict(no_model_launches(), waterfill_dense=0,
                balance_caps=cpc_invocations,
                waterfill_segmented=ticks * len(keys) + 2 * cpc_invocations)
    if launches != want:
        raise AssertionError(f"V: kernel launches {launches}, expected "
                             f"{want}")
    batch = run_sweep_batched(specs, policies)
    compare("V vs batch", gpu, batch, keys)
    cells = {f"{n}/{p}": dict(wall_s=gpu[n][p].wall_s,
                              ticks_per_s=gpu[n][p].ticks_per_s,
                              cap_changes=gpu[n][p].cap_changes,
                              cpu_satisfaction=gpu[n][p].cpu_satisfaction)
             for n, p in keys}
    log(f"path V: {len(keys)} cells x {ticks} ticks, {invocations} DRS "
        f"invocation(s) a cell: wall {wall:.3f} s "
        f"({ticks * len(keys) / wall:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(cells)}")
    return launches, dict(wall_s=wall, cells=len(keys), ticks=ticks,
                          per_cell=cells)

def check_k5_wide(dev) -> list:
    """P1's check: K5 at head dims 192 (Nemotron-4-340B's, zero-padded to
    256 by the wrapper) and 256, causal, 2 x 256 tokens, 8 query heads over
    8 and over 2 KV heads, in bf16 and float32, on the CUDA cores (32-row
    blocks at D 256), each against its plain version at phase 10's
    tolerances with two launches bitwise equal; the bf16 MHA calls timed
    beside the plain version and SDPA's backward.  Returns a record for
    each head dim."""
    from repro_torch.kernels.flash_attention import kernel_bwd
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention

    b, s, hq = 2, 256, 8
    out = []
    for d in (192, 256):
        errs, timed = {}, None
        for dtype in (torch.bfloat16, torch.float32):
            for hkv in (8, 2):
                q, k, v, do = attn_operands(b, s, s, hq, hkv, d, dtype, dev,
                                            300 + d + hkv)
                p = kernel_bwd.plan(b, s, s, hq, hkv, 256, dtype)
                if p.regime != "cuda_core" or max(p.smem_bytes) > 232_448:
                    raise AssertionError(f"K5 D {d}: plan {p}")
                case = f"{str(dtype)[6:]}_{hq}/{hkv}"
                errs[case], operands, _ = k5_case(
                    q, k, v, do, True, 0, f"K5 D {d} {case}", bitwise=True)
                if dtype == torch.bfloat16 and hkv == hq:
                    timed = operands
        q, k, v, o, lse, do = timed
        ms = time_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do))
        pms = time_ms(lambda: ref.flash_attention_bwd_ref(
            q, k, v, o, lse, do, block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
        both_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt),
            do.transpose(1, 2)))
        pairs = s * (s + 1) // 2
        bound, by = bound_ms(2 * 8 * b * s * hq * d + 4 * b * hq * s,
                             10 * b * hq * d * pairs, PEAK_BF16_FLOPS)
        log(f"T: K5 D {d} (cuda_core, {kernel_bwd.core_rows(256)}-row "
            f"blocks, smem {p.smem_bytes[0]} B) errs {json.dumps(errs)} "
            f"{ms:.4f} ms (plain {pms:.3f} ms, SDPA backward "
            f"{both_ms - fwd_ms:.4f} ms, bound {bound:.5f} ms)")
        out.append(dict(
            name=f"flash_attention_bwd {b}x{s}x{hq}x{d}", route="cuda",
            source="src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu",
            replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
            regime="cuda_core", padded_to=256, case_errs=errs,
            max_abs_err=max(errs[f"bfloat16_{hq}/{hq}"].values()),
            rtol=K5_TOL[torch.bfloat16], atol_per_rms=K5_TOL[torch.bfloat16],
            float32_max_abs_err=max(v for c, e in errs.items()
                                    if c.startswith("float32")
                                    for v in e.values()),
            ms=ms, plain_ms=pms, bound_ms=bound, bound_by=by,
            library_ms=both_ms - fwd_ms, smem_bytes=p.smem_bytes[0]))
    return out


#: Path D: ``sweep_grid_dpm``'s grid (``benchmarks/run.py``), as its
#: benchmark runs it: 100 hosts x 10 VMs, 4 churn families x 2 spikes x 2
#: host mixes x cpc/static = 32 cells, 1500 s at 15 s ticks, slot slack 1.5.
DPM_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                spikes=("burst", "prime"), heterogeneous=(False, True),
                churns=("none", "dpm", "maintenance", "failure"),
                duration_s=1500.0, tick_s=15.0)
DPM_SLACK = 1.5


def compare_final(tag, gpu, cpu, keys) -> None:
    """Final power states, occupancy and caps of two runs of one grid
    (``BatchResult``s) equal."""
    for i, (spec, p) in enumerate(keys):
        if not (np.array_equal(gpu.final_on[i], cpu.final_on[i])
                and np.array_equal(gpu.final_occ[i], cpu.final_occ[i])
                and np.allclose(gpu.final_caps[i], cpu.final_caps[i],
                                rtol=RTOL, atol=ATOL)):
            raise AssertionError(f"{tag} {spec.name}/{p}: final power "
                                 f"states, occupancy or caps differ")


def idle_share(run) -> dict:
    """One traced call of ``run``: the device's busy and idle share of its
    wall and its kernel launches, read from a ``torch.profiler`` trace of
    the device's activity alone (its kernels, copies and sets, as
    ``tools/profile_sweep_torch.py`` reads them; None when the trace holds
    no kernel event)."""
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT))
    from cpcbench.trace import busy_ns

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        return dict(device_idle_share=None, kernel_launches=None,
                    traced_wall_s=wall)
    copies = [e for e in events if e.get("cat") in ("gpu_memcpy",
                                                    "gpu_memset")]
    busy = busy_ns((e["ts"], e["ts"] + e["dur"])
                   for e in kernels + copies) * 1e-6
    return dict(device_idle_share=1.0 - busy / wall,
                kernel_launches=len(kernels), traced_wall_s=wall)


def run_churn_path(policies):
    """Path D: the ``sweep_grid_dpm`` grid through ``run_sweep(...,
    engine="batch")`` on the card, with the launch counts of exactly that
    run and the tick loop's branch reads, held against the same grid on
    the CPU (plain versions, their outermost calls counted): exact counts,
    payload and energy 1e-9, final states equal, every
    K1 and K2 launch one of the CPU run's plain calls, the budget within
    1e-6, and power-offs, power-ons and vMotions in the grid."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs = sweep.scenario_families(**DPM_GRID)
    keys = [(s, p) for s in specs for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep_batched(specs, policies, slot_slack=DPM_SLACK)
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    info, res = dict(record["info"]), record["result"]
    with count_plain_calls() as plain:
        cpu = sweep.run_sweep_batched(specs, policies, device="cpu",
                                      slot_slack=DPM_SLACK)
    cpu_res = sweep.LAST_BATCH_INFO[0]["result"]
    names = [(s.name, p) for s, p in keys]
    compare("D vs CPU", gpu, cpu, names)
    compare_final("D vs CPU", res, cpu_res, keys)
    want = dict(no_model_launches(), **plain)
    if launches != want or plain["waterfill_dense"] != info["ticks"] or \
            plain["balance_caps"] != info["invocation_ticks"]:
        raise AssertionError(f"D: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}, loop {info}")
    totals = {f: int(sum(getattr(gpu[n][p], f) for n, p in names))
              for f in ("cap_changes", "power_offs", "power_ons",
                        "vmotions")}
    if min(totals.values()) <= 0:
        raise AssertionError(f"D: the grid did not churn: {totals}")
    over = float(res.over_budget.max())
    if over > 1e-6:
        raise AssertionError(f"D: budget over by {over} W")
    cells, _ = sweep.build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=DPM_SLACK)
    traced = idle_share(sim.run)
    n = len(keys)
    engine_s = res.run_s
    out = dict(wall_s=wall, engine_s=engine_s, pack_s=res.pack_s, cells=n,
               cells_per_s=n / wall, engine_cells_per_s=n / engine_s,
               ticks=info["ticks"], invocation_ticks=info["invocation_ticks"],
               branch_reads=info["branch_reads"],
               branch_reads_per_tick=info["branch_reads"] / info["ticks"],
               max_over_budget_w=over, **totals,
               **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / info["ticks"]
    log(f"path D: {n} cells x {info['ticks']} ticks, {n / wall:.2f} cells/s "
        f"(engine {n / engine_s:.2f} cells/s, pack {res.pack_s:.3f} s); "
        f"launches {launches}; {json.dumps(out)}")
    return gpu, launches, out


def run_churn_vector_path(policies, batch):
    """Path W: the vector engine on the grid's first two ``dpm`` specs
    (the reference benchmark's sequential baseline) and its burst
    homogeneous ``maintenance`` and ``failure`` specs, on the card, held
    against the same cells on the CPU and against path D's results, with
    K3 and K2 launches equal to the CPU run's plain calls."""
    from repro_torch.sim.sweep import run_sweep, scenario_families

    specs = scenario_families(**DPM_GRID)
    chosen = [s for s in specs if s.churn == "dpm"][:2] + [
        s for s in specs if s.spike == "burst" and not s.heterogeneous
        and s.churn in ("maintenance", "failure")]
    names = [(s.name, p) for s in chosen for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(chosen, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    with count_plain_calls() as plain:
        cpu = run_sweep(chosen, policies, engine="vector", device="cpu")
    compare("W vs CPU", gpu, cpu, names)
    compare("W vs D", gpu, batch, names)
    if launches != dict(no_model_launches(), **plain):
        raise AssertionError(f"W: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}")
    ticks = gpu[names[0][0]][names[0][1]].ticks
    out = dict(wall_s=wall, cells=len(names), ticks=ticks,
               ticks_per_s=ticks * len(names) / wall,
               power_offs=sum(gpu[n][p].power_offs for n, p in names),
               vmotions=sum(gpu[n][p].vmotions for n, p in names))
    log(f"path W: {len(names)} cells x {ticks} ticks, wall {wall:.3f} s "
        f"({out['ticks_per_s']:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(out)}")
    return launches, out


def run_tree_path(policies):
    """Path R: ``row_contention_specs(sizes=(100,))`` (the ``two_row``
    budget tree binding row 0) on both engines on the card, each held
    against the CPU, with ``over_tree`` within 1e-6."""
    from repro_torch.sim import sweep

    specs = sweep.row_contention_specs(sizes=(100,))
    names = [(s.name, p) for s in specs for p in policies]
    gpu, launches_b, info = run_path("R", specs, policies)
    over_tree = float(sweep.LAST_BATCH_INFO[0]["result"].over_tree.max())
    cpu = sweep.run_sweep_batched(specs, policies, device="cpu")
    compare("R vs CPU", gpu, cpu, names)
    if over_tree > 1e-6 or float(
            sweep.LAST_BATCH_INFO[0]["result"].over_tree.max()) > 1e-6:
        raise AssertionError(f"R: a tree node over by {over_tree} W")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vgpu = sweep.run_sweep(specs, policies, engine="vector")
    vwall = time.perf_counter() - t0
    launches_v = read_launches()
    with count_plain_calls() as plain:
        vcpu = sweep.run_sweep(specs, policies, engine="vector",
                               device="cpu")
    compare("R vector vs CPU", vgpu, vcpu, names)
    compare("R vector vs batch", vgpu, gpu, names)
    if launches_v != dict(no_model_launches(), **plain):
        raise AssertionError(f"R vector: kernel launches {launches_v}, the "
                             f"CPU run's plain calls {plain}")
    info.update(max_over_tree_w=over_tree, vector_wall_s=vwall,
                vector_launches=launches_v,
                cap_changes=sum(gpu[n][p].cap_changes for n, p in names))
    log(f"path R: over_tree {over_tree:.3e} W; vector wall {vwall:.3f} s, "
        f"launches {launches_v}; {json.dumps(info)}")
    return launches_b, launches_v, info



#: Paths G and X: ``sweep_grid_rules``'s and ``sweep_grid_timed``'s grids
#: (``benchmarks/run.py:347``, ``:409``) at their own size: 32 cells of 100
#: hosts x 10 VMs each, 600 s at 10 s ticks, slot slack 1.5.
RULES_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                  spikes=("flat", "burst", "step", "prime"),
                  heterogeneous=(False, True),
                  rules=("violation_burst", "cap_blocked"),
                  duration_s=600.0, tick_s=10.0)
TIMED_GRID = dict(sizes=(100,), budgets_per_host_w=(250.0,),
                  spikes=("burst", "prime"), heterogeneous=(False, True),
                  churns=("timed_churn", "failure_cascade"),
                  rules=("none", "violation_burst"),
                  duration_s=600.0, tick_s=10.0)
MIG_SLACK = 1.5


@contextlib.contextmanager
def record_balancer_waterfills():
    """Yields a dict, filled as the run goes, of the first K1 inputs of each
    kind the migration balancer makes (``"full"``: its ``(S, H, J)``
    entitlement waterfill, ``"pair"``: its ``(S, 2, J)`` refill): the
    path's own inputs for the kernel phase.  The calls themselves go
    through unchanged."""
    from repro_torch.core import kernels as ck
    from repro_torch.kernels.powercap import ops

    seen, real_bm, real_wf = {}, ck.balance_migrations, ops.waterfill_dense

    def waterfill(capacity, floors, ceilings, weights, iters=200,
                  active=None, device=None):
        seen.setdefault("pair" if floors.shape[-2] == 2 else "full", (
            capacity.clone(), floors.clone(), ceilings.clone(),
            weights.clone(), active.clone(), iters))
        return real_wf(capacity, floors, ceilings, weights, iters, active,
                       device)

    def balance_migrations(*args, **kwargs):
        with mock.patch.object(ops, "waterfill_dense", waterfill):
            return real_bm(*args, **kwargs)

    with mock.patch.object(ck, "balance_migrations", balance_migrations):
        yield seen


def check_balancer_k1(tag: str, seen: dict, dev) -> list:
    """K1 against its plain version at the balancer's shapes, on the inputs
    a path's CPU run gave it (``record_balancer_waterfills``): bitwise,
    timed by CUDA events beside the plain version, with device time and
    bound."""
    from repro_torch.kernels.powercap import kernel, ops, ref

    out = []
    for kind in ("full", "pair"):
        cap, fl, ce, w, act = (t.to(dev) for t in seen[kind][:5])
        iters, shape = seen[kind][5], tuple(seen[kind][1].shape)
        got = ops.waterfill_dense(cap, fl, ce, w, iters, active=act)
        want = ref.waterfill_dense_ref(cap, fl, ce, w, iters, act)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: K1 at the balancer's {shape} "
                                 f"differs from its plain version (max abs "
                                 f"err {err})")
        ms = time_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, iters,
                                                 active=act))
        pms = time_ms(lambda: ref.waterfill_dense_ref(cap, fl, ce, w, iters,
                                                      act))
        dms = device_ms(lambda: ops.waterfill_dense(cap, fl, ce, w, iters,
                                                    active=act),
                        "waterfill_kernel")
        S, H, J = shape
        n = S * H * J
        trips = bisection_trips(cap, fl, ce, w, act, iters)
        b, by = bound_ms(8 * S * H + 3 * 8 * n + n + 8 * n,
                         float((4 * trips + 12).sum()) * J)
        g, k = kernel.row_shape(J)
        log(f"{tag}: K1 at the balancer's {S}x{H}x{J} (bitwise) {ms:.4f} ms, "
            f"device {fmt_ms(dms)} (plain {pms:.3f} ms), bound {b:.5f} ms")
        out.append(dict(
            name=f"waterfill_dense {S}x{H}x{J}", route="cuda",
            source="src/repro_torch/kernels/powercap/csrc/waterfill.cu",
            replaces="src/repro/kernels/powercap/kernel.py:48",
            inputs=f"the migration balancer's {kind} waterfill, from the "
                   f"path's CPU run",
            iters=iters, max_abs_err=err, bitwise=True, rtol=0.0, atol=0.0,
            ms=ms, device_ms=dms, plain_ms=pms, bound_ms=b, bound_by=by,
            library_ms=None, row_lanes=g, row_slots_a_lane=k,
            mean_trips=float(trips.double().mean())))
    return out


def cpu_migration_run(grid: dict, policies, engine: str = "batch") -> dict:
    """A migration grid on the CPU (``engine="batch"``: the whole grid at
    slot slack 1.5; ``"vector"``: the sequential baseline of path Q), the
    plain versions' outermost calls counted and the balancer's K1 inputs
    recorded.  The script makes these runs before the paths' traced ones:
    the K1 phase they feed reads device times from ``torch.profiler``,
    whose traces lose launches after a process has traced much."""
    from repro_torch.sim import sweep

    if engine == "vector":
        specs = (sweep.scenario_families(**RULES_GRID)[:2]
                 + sweep.scenario_families(**TIMED_GRID)[:2])
    else:
        specs = sweep.scenario_families(**grid)
    with count_plain_calls() as plain, record_balancer_waterfills() as seen:
        if engine == "batch":
            res = sweep.run_sweep_batched(specs, policies, device="cpu",
                                          slot_slack=MIG_SLACK)
        else:
            res = sweep.run_sweep(specs, policies, device="cpu")
    out = dict(specs=specs, res=res, plain=plain, seen=seen)
    if engine == "batch":
        (record,) = sweep.LAST_BATCH_INFO
        out.update(result=record["result"], info=dict(record["info"]))
    return out


def run_migration_path(tag: str, cpu: dict, policies, must_show):
    """Path G or X: the grid through ``run_sweep(..., engine="batch")`` on
    the card with the launch counts and reads of exactly that run, held
    against the same grid's CPU run (``cpu_migration_run``): exact counts,
    payload and energy 1e-9, final states equal, the loop's reads equal,
    every K1 and K2 launch one of the CPU run's plain calls, the budget
    within 1e-6, and ``must_show`` counts in the grid.  Returns ``(gpu
    results, launches, info)``."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs, plain = cpu["specs"], cpu["plain"]
    keys = [(s, p) for s in specs for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep_batched(specs, policies, slot_slack=MIG_SLACK)
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    info, res = dict(record["info"]), record["result"]
    names = [(s.name, p) for s, p in keys]
    compare(f"{tag} vs CPU", gpu, cpu["res"], names)
    compare_final(f"{tag} vs CPU", res, cpu["result"], keys)
    if launches != dict(no_model_launches(), **plain) or \
            plain["balance_caps"] != info["invocation_ticks"] or \
            plain["waterfill_dense"] <= info["ticks"] or \
            info != cpu["info"]:
        raise AssertionError(f"{tag}: kernel launches {launches}, the CPU "
                             f"run's plain calls {plain}, loop {info}, the "
                             f"CPU run's loop {cpu['info']}")
    totals = {f: int(sum(getattr(gpu[n][p], f) for n, p in names))
              for f in ("cap_changes", "power_offs", "power_ons",
                        "vmotions")}
    if min(totals[f] for f in must_show) <= 0:
        raise AssertionError(f"{tag}: the grid shows none of {must_show}: "
                             f"{totals}")
    over = float(res.over_budget.max())
    if over > 1e-6:
        raise AssertionError(f"{tag}: budget over by {over} W")
    cells, _ = sweep.build_batch_cells(specs, policies)
    sim = BatchedSimulator(cells, slot_slack=MIG_SLACK,
                           balancer=sweep.grid_balancer(specs))
    traced = idle_share(sim.run)
    n, ticks = len(keys), info["ticks"]
    out = dict(wall_s=wall, engine_s=res.run_s, pack_s=res.pack_s, cells=n,
               cells_per_s=n / wall, engine_cells_per_s=n / res.run_s,
               ticks=ticks, invocation_ticks=info["invocation_ticks"],
               branch_reads=info["branch_reads"],
               migration_reads=info["migration_reads"],
               reads_per_tick=info["branch_reads"] / ticks,
               max_over_budget_w=over, **totals, **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / ticks
    log(f"path {tag}: {n} cells x {ticks} ticks, {n / wall:.2f} cells/s "
        f"(engine {n / res.run_s:.2f} cells/s, pack {res.pack_s:.3f} s); "
        f"launches {launches}; {json.dumps(out)}")
    return gpu, launches, out


def run_migration_vector_path(policies, batches, cpu: dict):
    """Path Q: the vector engine on ``specs[:2]`` of G's and X's grids (the
    reference benchmarks' sequential baselines), cpc and static, on the
    card, held against the same cells' CPU run (``cpu_migration_run``, K1-K3
    launches equal to its plain calls) and against paths G's and X's
    results; ticks/s, launches a tick and the idle share printed.  Returns
    ``(launches, info)``."""
    from repro_torch.sim.sweep import run_sweep

    chosen = cpu["specs"]
    names = [(s.name, p) for s in chosen for p in policies]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = run_sweep(chosen, policies, engine="vector")
    wall = time.perf_counter() - t0
    launches = read_launches()
    compare("Q vs CPU", gpu, cpu["res"], names)
    for batch, group in zip(batches, (names[:4], names[4:])):
        compare("Q vs batch", gpu, batch, group)
    if launches != dict(no_model_launches(), **cpu["plain"]):
        raise AssertionError(f"Q: kernel launches {launches}, the CPU run's "
                             f"plain calls {cpu['plain']}")
    traced = idle_share(lambda: run_sweep(chosen, policies,
                                          engine="vector"))
    ticks = gpu[names[0][0]][names[0][1]].ticks
    out = dict(wall_s=wall, cells=len(names), ticks=ticks,
               ticks_per_s=ticks * len(names) / wall,
               cells_per_s=len(names) / wall,
               vmotions=sum(gpu[n][p].vmotions for n, p in names),
               cap_changes=sum(gpu[n][p].cap_changes for n, p in names),
               **traced)
    if traced["kernel_launches"] is not None:
        out["launches_per_tick"] = traced["kernel_launches"] / (
            ticks * len(names))
    log(f"path Q: {len(names)} cells x {ticks} ticks, wall {wall:.3f} s "
        f"({out['ticks_per_s']:.1f} ticks/s); launches {launches}; "
        f"{json.dumps(out)}")
    return launches, out

#: Worker processes for the CPU runs that paths E, U and C are held
#: against, and the torch threads each takes: they run while the card runs
#: the earlier paths.
CPU_WORKERS = 2
CPU_WORKER_THREADS = 2

#: Path E: EXPERIMENTS.md's Tables III-V as ``benchmarks/run.py`` prints
#: them, and Table II.
EVAL_SCENARIOS = ("headroom", "standby", "flexible")
#: The scenarios whose legacy CPU runs give path E's kernel phase its K2
#: and K3 inputs: 3 hosts x 10 VMs, and 32 hosts x 6-9 VMs (25 hosts under
#: statichigh).
E_RECORDED = ("headroom", "flexible")
EVAL_TABLES = {
    "headroom": "cpc:cpu0.99/vmo0;static:cpu0.99/vmo4;statichigh:cpu1.00/vmo0",
    "standby": "cpc:cpu1.00/vmo10/pow1.00;static:cpu1.00/vmo20/pow1.07;"
               "statichigh:cpu1.00/vmo10/pow1.00",
    "flexible": "cpc:cpu1.25/mem1.30/trd1.00;static:cpu1.14/mem1.30/trd0.64;"
                "statichigh:cpu1.00/mem1.00/trd1.00",
}
TABLE2 = ("400W:20hosts/cpu1.00/mem1.00;320W:25hosts/cpu1.25/mem1.25;"
          "285W:28hosts/cpu1.09/mem1.40;250W:32hosts/cpu0.90/mem1.60")
ACC_FLOATS = ("cpu_payload_mhz_s", "cpu_demand_mhz_s", "mem_payload_mb_s",
              "mem_demand_mb_s", "energy_j")
ACC_COUNTS = ("cap_changes", "vmotions", "power_ons", "power_offs")

#: Path U: ``scenario_families()`` (10/100/1000 hosts, burst and prime,
#: both host mixes, 1200 s at 10 s) under the three policies, and one
#: cell on another time grid that the batched engine refuses.
U_POLICIES = ("cpc", "static", "statichigh")
U_BUCKETS = [(16, 16), (128, 16), (1024, 16)]

#: Path C: ``benchmarks/sweep_sharded.py``'s ``datacenter_cell``.
C_HOSTS = 10_000
C_POLICIES = ("cpc", "static")

#: The ``budget_service`` benchmark's replay (``benchmarks/
#: check_regression.py``), and the decisions and errors the reference's
#: service gives on it (``tests/test_torch_budget_service.py`` holds the
#: port's to them bitwise on the CPU).
SVC_HOSTS, SVC_EVENTS = 50, 4000
SVC_DECISIONS, SVC_ERRORS = 820, 755


def u_specs():
    from repro_torch.sim.sweep import SweepSpec, scenario_families
    return scenario_families() + [SweepSpec(
        name="h10_burst_odd_grid", n_hosts=10, spike="burst",
        duration_s=600.0, tick_s=10.0)]


def c_spec():
    from repro_torch.sim.sweep import SweepSpec
    return SweepSpec(name=f"h{C_HOSTS}_burst", n_hosts=C_HOSTS,
                     spike="burst", rack_budget_w=230.0 * C_HOSTS,
                     duration_s=600.0, tick_s=30.0)


def eval_summary(res: dict) -> dict:
    """The parts of ``run_all``'s results the gates compare, by policy."""
    def acc(a):
        if a is None:
            return None
        return dict({f: getattr(a, f) for f in ACC_FLOATS + ACC_COUNTS},
                    tag_payload=dict(a.tag_payload),
                    tag_demand=dict(a.tag_demand))
    return {p: dict(acc=acc(r.acc), window=acc(r.window_acc),
                    events=list(r.events),
                    hosts={h: (x.powered_on, x.power_cap)
                           for h, x in r.final.hosts.items()},
                    placement={v: x.host_id for v, x in r.final.vms.items()})
            for p, r in res.items()}


def sweep_summary(res: dict) -> dict:
    return {name: {p: dataclasses.asdict(r) for p, r in per.items()}
            for name, per in res.items()}


def tree_map(fn, x):
    """``fn`` applied to each tensor in ``x`` (tensors, named tuples and
    tuples of them, other values as they are)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple):
        items = [tree_map(fn, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


@contextlib.contextmanager
def record_eval_inputs():
    """Yields a dict, filled as a CPU run goes, of the first inputs of each
    shape that K3's and K2's plain versions get (K3: items x hosts, K2:
    ``(S, H, J)``): path E's own inputs for its kernel phase
    (``check_eval_kernels``).  The calls themselves go through unchanged."""
    from repro_torch.kernels.powercap import ref

    seen = {}

    def recording(name, shape):
        fn = getattr(ref, f"{name}_ref")

        def call(*args):
            key = (name, shape(*args))
            if key not in seen:
                seen[key] = tree_map(torch.clone, args)
            return fn(*args)
        return call

    with mock.patch.object(ref, "waterfill_segmented_ref", recording(
            "waterfill_segmented", lambda cap, fl, *_: (cap.numel(),
                                                        fl.numel()))), \
            mock.patch.object(ref, "balance_caps_ref", recording(
                "balance_caps", lambda hosts, caps, dense, *_: tuple(
                    dense.floors.shape))):
        yield seen


def check_eval_kernels(jobs: dict, dev) -> list:
    """K3 and K2 against their plain versions on the inputs that path E's
    CPU runs of ``headroom`` and ``flexible`` on the legacy engine gave
    them, one of each shape (``record_eval_inputs``), bitwise; each timed
    beside its plain version, with its bound."""
    from repro_torch.kernels.powercap import ops, ref

    out = []
    for scenario in E_RECORDED:
        seen = jobs["E", scenario, "legacy"].result()[2]
        for (name, shape), args in sorted(seen.items()):
            args = tree_map(lambda t: t.to(dev), args)
            inputs = f"path E's CPU run of {scenario} (legacy engine)"
            if name == "balance_caps":
                out.append(check_k2(f"E {scenario}", args, bitwise=True,
                                    inputs=inputs))
                continue
            cap, fl, ce, w, lay, iters = args
            got = ops.waterfill_segmented(cap, fl, ce, w, iters=iters,
                                          layout=lay)
            want = ref.waterfill_segmented_ref(cap, fl, ce, w, lay, iters)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(f"E {scenario}: K3 at {shape} differs "
                                     f"from its plain version (max abs err "
                                     f"{err})")
            ms, pms, bound, by, trips = k3_cost(cap, fl, ce, w, lay, iters)
            log(f"E {scenario}: K3 at {shape[0]} hosts x {shape[1]} VMs "
                f"(bitwise) {ms:.4f} ms (plain {pms:.3f} ms), bound "
                f"{bound:.6f} ms, rows of {lay.jb} slots")
            out.append(k3_record(*shape, inputs=inputs, iters=iters,
                                 max_abs_err=err, bitwise=True, rtol=0.0,
                                 atol=0.0, ms=ms, plain_ms=pms,
                                 bound_ms=bound, bound_by=by,
                                 mean_trips=float(trips.double().mean())))
    return out


def cpu_job(kind: str, *args):
    """A CPU run in a worker process, its plain calls of K1-K3 counted:
    ``("E", scenario, engine)`` is ``run_all``, ``("U",)`` path U's
    ``run_sweep`` and ``("C",)`` path C's.  Returns ``(summary, plain
    calls, extra)``: U's and C's bucket records, or the K2 and K3 inputs
    recorded in E's run (``record_eval_inputs``)."""
    import warnings
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(CPU_WORKER_THREADS)
    from repro_torch.sim import experiments, sweep

    with count_plain_calls() as plain, warnings.catch_warnings(), \
            record_eval_inputs() as seen:
        warnings.simplefilter("ignore", RuntimeWarning)
        if kind == "E":
            out = eval_summary(experiments.run_all(args[0], engine=args[1],
                                                   device="cpu"))
        elif kind == "U":
            out = sweep.run_sweep(u_specs(), U_POLICIES, engine="batch",
                                  on_unsupported="fallback", device="cpu")
        else:
            out = sweep.run_sweep([c_spec()], C_POLICIES, engine="batch",
                                  device="cpu")
    if kind != "E":
        return sweep_summary(out), dict(plain), list(sweep.LAST_BATCH_INFO)
    return out, dict(plain), seen


# ------------------------------------------- phase DR and the step counts
#: Phase DR: the dry run (``launch/dryrun.py``) of one cell of each family
#: on each production mesh, on a fake process group in a worker process.
DR_CELLS = [("minicpm_2b", "train_4k"), ("olmoe_1b_7b", "decode_32k"),
            ("mamba2_2p7b", "train_4k"), ("zamba2_7b", "long_500k"),
            ("internvl2_26b", "decode_32k"), ("whisper_tiny", "decode_32k")]
#: The steps whose warm time the paths measure, as they run them:
#: ``(arch, layers or None for all, kind, positions, batch)``; a decode
#: step's positions are its cache's (the plain K6 reads it whole).
ROOFLINE_STEPS = {
    "S": ("granite_8b", None, "decode", 1024, 8),
    "M": ("olmoe_1b_7b", None, "decode", 1024, 8),
    "P": ("mamba2_2p7b", None, "decode", 1024, 8),
    "H": ("zamba2_7b", None, "decode", 1024, 8),
    "I": ("internvl2_26b", None, "decode", 1024, 8),
    "Y": ("whisper_tiny", None, "decode", TEXT_CTX, 8),
    "T": ("minicpm_2b", T_LAYERS, "train", 4096, 4),
    "TM": ("olmoe_1b_7b", FAMILY_PATHS["TM"][1], "train", 4096, 4),
    "TP": ("mamba2_2p7b", FAMILY_PATHS["TP"][1], "train", 4096, 4),
    "TH": ("zamba2_7b", FAMILY_PATHS["TH"][1], "train", 4096, 4),
    "TI": ("internvl2_26b", TI_LAYERS, "train", TI_ROWS, TI_BATCH),
    "TY": ("whisper_tiny", None, "train", TEXT_CTX, TY_BATCH)}


def dr_job() -> list:
    """Phase DR in a worker: ``run_cell`` for :data:`DR_CELLS` on both
    meshes, its JSON written to a new temporary directory and removed."""
    torch.set_num_threads(CPU_WORKER_THREADS)
    from repro_torch.launch import dryrun

    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    try:
        return [dryrun.run_cell(arch, shape, multi, out, force=True)
                for arch, shape in DR_CELLS for multi in (False, True)]
    finally:
        shutil.rmtree(out, ignore_errors=True)


def roofline_job() -> dict:
    """Each of :data:`ROOFLINE_STEPS` counted on ``meta`` stand-ins
    (``dryrun.run_step``: the global step, no mesh) and its kernel-path
    roofline on one H100 (``dryrun.kernel_path_bound``)."""
    torch.set_num_threads(CPU_WORKER_THREADS)
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    out = {}
    for tag, (arch, layers, kind, seq, batch) in ROOFLINE_STEPS.items():
        cfg = configs.get(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        shape = ShapeConfig(tag, kind, seq, batch)
        t0 = time.perf_counter()
        cost = dryrun.run_step(cfg, shape)["cost"]
        bound = dryrun.kernel_path_bound(cfg, shape, 1, cost.flops,
                                         cost.bytes)
        out[tag] = dict(flops=cost.flops, bytes=cost.bytes,
                        product_flops=cost.product_flops,
                        bound_ms=bound["bound_s"] * 1e3,
                        t_memory_ms=bound["t_memory_s"] * 1e3,
                        dominant=bound["dominant"],
                        count_s=time.perf_counter() - t0)
    return out


def report_dryrun(cells: list) -> dict:
    """Phase DR's lines: each cell's dominant term and wall; raises for a
    cell that failed."""
    for r in cells:
        if not r["ok"]:
            raise AssertionError(f"DR {r['cell']}: {r.get('error')}\n"
                                 f"{r.get('traceback')}")
        log(f"DR {r['cell']}: dominant {r['roofline']['dominant']} "
            f"({r['roofline']['bound_s']:.4e} s), kernel path "
            f"{r['roofline_kernel_path']['dominant']}; flops/device "
            f"{r['flops_per_device']:.4e}, bytes/device "
            f"{r['bytes_per_device']:.4e}, collective bytes/device "
            f"{r['collective_bytes_per_device']['total']}; useful flops "
            f"{r['useful_flops_ratio']}; wall {r['wall_s']} s (CPU)")
    return {r["cell"]: {k: r[k] for k in (
        "wall_s", "flops_per_device", "bytes_per_device",
        "useful_flops_ratio", "roofline", "roofline_kernel_path",
        "collective_bytes_per_device")} for r in cells}


def report_roofline(counts: dict, infos: dict, smi: str) -> dict:
    """Each timed step's kernel-path roofline bound beside its measured
    warm time (``decode_step_ms`` or ``warm_step_ms`` of its path's info),
    as a share."""
    out = {}
    for tag, c in counts.items():
        info = infos[tag]
        ms = info.get("decode_step_ms", info.get("warm_step_ms"))
        share = c["bound_ms"] / ms
        out[tag] = dict(c, measured_ms=ms, share=share)
        log(f"roofline {tag}: {c['flops']:.4e} FLOPs, {c['bytes']:.4e} "
            f"bytes counted ({c['count_s']:.1f} s on the CPU); kernel-path "
            f"bound {c['bound_ms']:.3f} ms ({c['dominant']}) beside the "
            f"warm step {ms:.3f} ms: share {share:.4f} on {smi}")
    return out


def start_cpu_jobs(pool) -> dict:
    """The CPU runs, E's recording runs first: the kernel phase at the
    script's start waits for them.  Phase DR and the step counts come
    last: nothing reads them before the mesh paths end."""
    jobs = {("E", s, "legacy"): pool.submit(cpu_job, "E", s, "legacy")
            for s in E_RECORDED}
    jobs["C",] = pool.submit(cpu_job, "C")
    jobs["U",] = pool.submit(cpu_job, "U")
    for scenario in ("flexible", "headroom", "standby"):
        for engine in ("legacy", "vector"):
            if ("E", scenario, engine) not in jobs:
                jobs["E", scenario, engine] = pool.submit(
                    cpu_job, "E", scenario, engine)
    jobs["DR",] = pool.submit(dr_job)
    jobs["roofline",] = pool.submit(roofline_job)
    return jobs


def compare_eval(tag: str, got: dict, want: dict) -> None:
    """Exact counts and event strings, final power states and placement,
    payload, demand, memory, energy and per-tag payload (and the window's)
    within 1e-9."""
    for p, w in want.items():
        g = got[p]
        if g["events"] != w["events"]:
            raise AssertionError(f"{tag} {p}: event strings differ")
        if g["placement"] != w["placement"]:
            raise AssertionError(f"{tag} {p}: final placement differs")
        for h, (on, cap) in w["hosts"].items():
            if g["hosts"][h][0] != on or not abs(
                    g["hosts"][h][1] - cap) <= RTOL * abs(cap):
                raise AssertionError(f"{tag} {p}: host {h} ends "
                                     f"{g['hosts'][h]}, not {(on, cap)}")
        for part in ("acc", "window"):
            a, b = g[part], w[part]
            if (a is None) != (b is None):
                raise AssertionError(f"{tag} {p}: {part} present in one run")
            if b is None:
                continue
            for f in ACC_COUNTS:
                if a[f] != b[f]:
                    raise AssertionError(f"{tag} {p} {part}: {f} {a[f]} vs "
                                         f"{b[f]}")
            pairs = [(f, a[f], b[f]) for f in ACC_FLOATS]
            if a["tag_payload"].keys() != b["tag_payload"].keys():
                raise AssertionError(f"{tag} {p}: tags differ")
            for t in b["tag_payload"]:
                pairs += [(f"payload {t}", a["tag_payload"][t],
                           b["tag_payload"][t]),
                          (f"demand {t}", a["tag_demand"][t],
                           b["tag_demand"][t])]
            for f, x, y in pairs:
                if not abs(x - y) <= RTOL * abs(y):
                    raise AssertionError(f"{tag} {p} {part} {f}: {x!r} vs "
                                         f"{y!r}")


def eval_table(summary: dict, scenario: str) -> str:
    """``benchmarks/run.py``'s Table III, IV or V line."""
    from repro_torch.sim.metrics import Accumulators, ratio_table
    accs = {}
    for p, r in summary.items():
        a = r["acc"]
        accs[p] = Accumulators(**{k: a[k] for k in ACC_FLOATS + ACC_COUNTS},
                               tag_payload=a["tag_payload"],
                               tag_demand=a["tag_demand"])
    t = ratio_table(accs, "statichigh")
    pols = ("cpc", "static", "statichigh")
    if scenario == "headroom":
        return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                        f"/vmo{t[p]['vmotions']}" for p in pols)
    if scenario == "standby":
        return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                        f"/vmo{t[p]['vmotions']}"
                        f"/pow{t[p]['power_ratio']:.2f}" for p in pols)
    return ";".join(f"{p}:cpu{t[p]['cpu_payload_ratio']:.2f}"
                    f"/mem{t[p]['mem_payload_ratio']:.2f}"
                    f"/trd{accs[p].tag_satisfaction('trading'):.2f}"
                    for p in pols)


def run_eval_path(jobs: dict):
    """Path E: ``run_all`` of the three scenarios on the legacy and the
    vector engine on the card, each held against its CPU run (counts and
    event strings exact, accumulators 1e-9, K1-K3 launches equal to its
    plain calls), legacy against vector on the card; Tables II-V printed
    and held to EXPERIMENTS.md's lines.  Returns ``(launches, info)``."""
    from repro_torch.core.power_model import PAPER_HOST, deployment_table
    from repro_torch.sim import experiments

    rows = deployment_table(PAPER_HOST, 8000.0, [400, 320, 285, 250])
    table2 = ";".join(f"{int(r['power_cap_w'])}W:{r['host_count']}hosts"
                      f"/cpu{r['capacity_ratio']:.2f}"
                      f"/mem{r['memory_ratio']:.2f}" for r in rows)
    if table2 != TABLE2:
        raise AssertionError(f"E: Table II {table2}")
    log(f"E: Table II {table2}")
    launches = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
    got, info = {}, {"table2": table2, "engines": {}}
    for engine in ("legacy", "vector"):
        per = info["engines"][engine] = {}
        for scenario in EVAL_SCENARIOS:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = experiments.run_all(scenario, engine=engine)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_launches = read_launches()
            got[scenario, engine] = summary = eval_summary(res)
            cpu, plain, _ = jobs["E", scenario, engine].result()
            compare_eval(f"E {scenario}/{engine} vs CPU", summary, cpu)
            if run_launches != dict(no_model_launches(), **plain):
                raise AssertionError(
                    f"E {scenario}/{engine}: kernel launches "
                    f"{run_launches}, the CPU run's plain calls {plain}")
            line = eval_table(summary, scenario)
            if line != EVAL_TABLES[scenario]:
                raise AssertionError(f"E {scenario}/{engine}: {line}")
            launches = {k: launches[k] + run_launches[k] for k in launches}
            per[scenario] = dict(
                wall_s=wall, launches={k: run_launches[k] for k in KERNELS},
                table=line, counts={p: {f: summary[p]["acc"][f]
                                        for f in ACC_COUNTS}
                                    for p in summary})
            log(f"E {scenario}/{engine}: wall {wall:.3f} s, launches "
                f"{json.dumps(per[scenario]['launches'])}; {line}")
    for scenario in EVAL_SCENARIOS:
        compare_eval(f"E {scenario} legacy vs vector",
                     got[scenario, "legacy"], got[scenario, "vector"])
    for engine, per in info["engines"].items():
        log(f"E {engine}: wall {sum(r['wall_s'] for r in per.values()):.3f}"
            f" s for the 9 runs")
    return launches, info


def run_bucket_path(job):
    """Path U: ``run_sweep(u_specs(), engine="batch",
    on_unsupported="fallback")`` on the card: three pad buckets of 12
    cells and the odd-grid cells on the vector engine, with its warning;
    held against the CPU run of the same call (counts exact, 1e-9, final
    states equal, K1-K3 launches equal to its plain calls) and against
    ``run_sweep_batched`` on the card (counts equal, 1e-12).  Returns
    ``(launches, info)``."""
    import warnings
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    specs = u_specs()
    per_bucket = []
    real = BatchedSimulator.run_async

    def counted(sim):
        before = read_launches()
        pending = real(sim)
        after = read_launches()
        per_bucket.append({k: after[k] - before[k] for k in KERNELS})
        return pending

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(BatchedSimulator, "run_async", counted), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gpu = sweep.run_sweep(specs, U_POLICIES, engine="batch",
                              on_unsupported="fallback")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    records = list(sweep.LAST_BATCH_INFO)
    odd = [f"{specs[-1].name}/{p}" for p in U_POLICIES]
    said = [str(w.message) for w in caught
            if issubclass(w.category, RuntimeWarning)]
    if len(said) != 1 or "sequential vector engine" not in said[0] or \
            not all(name in said[0] for name in odd):
        raise AssertionError(f"U: the fallback warning {said}")
    if [r["bucket"] for r in records] != U_BUCKETS or \
            [r["n_cells"] for r in records] != [12] * len(U_BUCKETS):
        shapes = [(r["bucket"], r["n_cells"]) for r in records]
        raise AssertionError(f"U: buckets {shapes}")
    for r, n in zip(records, per_bucket):
        want = dict(waterfill_dense=r["info"]["ticks"],
                    balance_caps=r["info"]["invocation_ticks"],
                    waterfill_segmented=0)
        if n != want:
            raise AssertionError(f"U bucket {r['bucket']}: launches {n}, "
                                 f"expected {want}")
    cpu, plain, cpu_records = job.result()
    names = [(s.name, p) for s in specs for p in U_POLICIES]
    compare("U vs CPU", gpu, sweep_results(cpu), names)
    for r, c in zip(records, cpu_records):
        keys = [n.split("/") for n in r["result"].names]
        compare_final(f"U bucket {r['bucket']} vs CPU", r["result"],
                      c["result"], [(SimpleNamespace(name=n), p)
                                    for n, p in keys])
    if launches != dict(no_model_launches(), **plain):
        raise AssertionError(f"U: kernel launches {launches}, the CPU "
                             f"run's plain calls {plain}")
    batched = specs[:-1]
    cells = sweep.build_batch_cells(batched, U_POLICIES)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    exact = sweep.run_sweep_batched(batched, U_POLICIES, _prebuilt=cells)
    torch.cuda.synchronize()
    exact_wall = time.perf_counter() - t1
    exact_record = dict(sweep.LAST_BATCH_INFO[0])
    compare("U bucketed vs exact pack", gpu, exact,
            [(s.name, p) for s in batched for p in U_POLICIES], rtol=1e-12)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        traced = idle_share(lambda: sweep.run_sweep(
            specs, U_POLICIES, engine="batch", on_unsupported="fallback"))
    n = len(names)
    buckets = [dict({k: r[k] for k in ("bucket", "n_cells", "n_devices",
                                        "compile_s", "pack_s", "run_s",
                                        "wall_s")},
                    launches=per, **r["info"])
               for r, per in zip(records, per_bucket)]
    out = dict(wall_s=wall, cells=n, cells_per_s=n / wall,
               fallback_cells=len(odd), buckets=buckets,
               exact_pack_wall_s=exact_wall,
               exact_pack_run_s=exact_record["run_s"],
               exact_pack_shape=list(exact_record["result"].final_occ.shape),
               cap_changes=sum(gpu[a][b].cap_changes for a, b in names),
               **traced)
    for b in buckets:
        log(f"U bucket {b['bucket']}: {json.dumps(b)}")
    log(f"path U: {n} cells ({len(odd)} on the vector engine), wall "
        f"{wall:.3f} s ({n / wall:.2f} cells/s), exact pack "
        f"{exact_wall:.3f} s; launches {launches}; {json.dumps(out)}")
    return launches, out


def sweep_results(summary: dict) -> dict:
    """``sweep_summary``'s dicts as objects ``compare`` reads."""
    return {n: {p: SimpleNamespace(**r) for p, r in per.items()}
            for n, per in summary.items()}


def run_datacenter_path(job):
    """Path C: ``datacenter_cell`` (10,000 hosts x 10 VMs, 230 W a host,
    burst, 600 s at 30 s) under cpc and static through ``run_sweep(...,
    engine="batch")`` on the card, one pad bucket of (16384, 16): held
    against its CPU run (counts exact, 1e-9, final states equal, K1 and
    K2 launches its plain calls), the cpc cell changing caps.  Returns
    ``(launches, info)``."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator

    spec = c_spec()
    names = [(spec.name, p) for p in C_POLICIES]
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpu = sweep.run_sweep([spec], C_POLICIES, engine="batch")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    (record,) = sweep.LAST_BATCH_INFO
    if record["bucket"] != (sweep._pow2(C_HOSTS), 16):
        raise AssertionError(f"C: bucket {record['bucket']}")
    cpu, plain, (cpu_record,) = job.result()
    compare("C vs CPU", gpu, sweep_results(cpu), names)
    compare_final("C vs CPU", record["result"], cpu_record["result"],
                  [(spec, p) for p in C_POLICIES])
    if launches != dict(no_model_launches(), **plain) or \
            plain["waterfill_dense"] != record["info"]["ticks"]:
        raise AssertionError(f"C: kernel launches {launches}, the CPU run's "
                             f"plain calls {plain}")
    if gpu[spec.name]["cpc"].cap_changes <= 0:
        raise AssertionError("C: the cpc cell changed no cap")
    cells, _ = sweep.build_batch_cells([spec], C_POLICIES)
    sim = BatchedSimulator(cells, slot_slack=3.0,
                           pad_hosts=sweep._pow2(C_HOSTS), pad_slots=16)
    traced = idle_share(sim.run)
    out = dict(wall_s=wall, bucket=list(record["bucket"]),
               compile_s=record["compile_s"], pack_s=record["pack_s"],
               run_s=record["run_s"], **record["info"],
               cap_changes={p: gpu[spec.name][p].cap_changes
                            for p in C_POLICIES},
               cpu_satisfaction={p: gpu[spec.name][p].cpu_satisfaction
                                 for p in C_POLICIES}, **traced)
    log(f"path C: {C_HOSTS} hosts, bucket {record['bucket']}, wall "
        f"{wall:.3f} s (engine {record['run_s']:.3f} s, pack "
        f"{record['pack_s']:.3f} s); launches {launches}; {json.dumps(out)}")
    return launches, out


def run_service_phase(smi: str) -> dict:
    """The ``budget_service`` benchmark's replay on the port: 50 hosts, the
    two-row tree with row 0 at 45% of the budget, 4,000 events from seed
    0; headroom against brute force at the reference's 1e-9 bar, the
    decision and error counts the reference's; p50/p99 host latencies."""
    from repro_torch.core.budget_tree import BudgetTree
    from repro_torch.runtime import budget_service as bsvc

    budget = 250.0 * SVC_HOSTS
    tree = BudgetTree.two_rows(budget, SVC_HOSTS, row0_limit=0.45 * budget)
    hosts = [f"host{i}" for i in range(SVC_HOSTS)]
    on = np.ones(SVC_HOSTS, dtype=bool)
    caps0 = tree.project(np.full(SVC_HOSTS, 250.0), on,
                         floors=np.zeros(SVC_HOSTS))
    svc = bsvc.BudgetService(tree, hosts, caps0, on)
    rep = svc.replay(bsvc.synthetic_feed(tree, n_events=SVC_EVENTS, seed=0))
    parity = max(abs(svc.headroom(h) - svc.brute_force_headroom(h))
                 for h in hosts)
    if parity > 1e-9 or (rep.n_decisions, rep.n_errors) != (SVC_DECISIONS,
                                                             SVC_ERRORS):
        raise AssertionError(f"service: parity {parity}, decisions "
                             f"{rep.n_decisions}, errors {rep.n_errors}")
    out = dict(n_events=rep.n_events, n_decisions=rep.n_decisions,
               n_errors=rep.n_errors, host_p50_us=rep.p50_us,
               host_p99_us=rep.p99_us, headroom_parity_max_w=parity,
               card=smi)
    log(f"service: {rep.n_events} events, {rep.n_decisions} decisions, "
        f"{rep.n_errors} errors; host latency p50 {rep.p50_us:.2f} us, "
        f"p99 {rep.p99_us:.2f} us (on the host beside {smi}); headroom "
        f"against brute force {parity:.3e} W")
    return out


# ====================================================== paths SC, ME, TE
#: Path SC's per-cell fields, held bitwise across worlds.
SC_FIELDS = ("cap_changes", "vmotions", "power_ons", "power_offs",
             "energy_j", "cpu_payload_mhz_s", "cpu_satisfaction")
#: Path SC's grid A's cells (16 specs x cpc/static): a rank of world 2
#: runs 16 of them with K2 planned for all 32 (``sim/batch.py``'s
#: ``plan_cells``), and SC's K2 record is timed at that plan.
SC_CELLS = 32
#: A spawned phase's time limit (s): past it every rank is killed.
MESH_TIMEOUT_S = 600.0
#: Path ME: one OLMoE-1B-7B MoE layer on 8 x 512 tokens; path TE:
#: MiniCPM-2B at full width and 4 layers, 3 steps a phase of a global
#: batch of 4 x 1024 tokens.
ME_TOKENS = (8, 512)
TE_LAYERS, TE_SEQ, TE_BATCH, TE_STEPS = 4, 1024, 4, 3


def mesh_line(kind: str, world: int, layout: str | None = None) -> str:
    """The backend and devices the mesh's rule gives ``world`` ranks, and
    the ``layout`` they run."""
    from repro_torch.launch import mesh
    n = torch.cuda.device_count()
    return (f"mesh: {world} rank(s) on {kind} "
            f"({', '.join(f'cuda:{r % n}' for r in range(world))}), backend "
            f"{mesh.backend_for(kind, world)} by the rule (nccl when each "
            f"rank owns a card, gloo when ranks share one)"
            + (f"; layout {layout}" if layout else ""))


@contextlib.contextmanager
def timed_collectives(*modules):
    """Each module's ``all_reduce``, ``all_gather`` and ``reduce_scatter``
    timed, the card synchronized on both sides; yields a list: the
    seconds spent in them, and their count."""
    from repro_torch.runtime import sharding
    spent = [0.0, 0]

    def timed(real):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return call
    with contextlib.ExitStack() as stack:
        for mod in modules:
            for name in ("all_reduce", "all_gather", "reduce_scatter"):
                if hasattr(mod, name):
                    stack.enter_context(mock.patch.object(
                        mod, name, timed(getattr(sharding, name))))
        yield spent


def sc_grids() -> dict:
    """Path SC's grids, ``tag -> (specs, policies, entry point, slot
    slack)``: path A's ``sweep_grid`` (32 cells of 100 hosts), path D's
    dynamic grid (32 cells on the churn program), the reference's
    ``row_contention_specs(sizes=(10,))`` through the pad buckets, and
    A's first three specs under cpc (three cells: two ranks pad one
    copy)."""
    from repro_torch.sim import sweep
    specs_a = sweep.scenario_families(
        sizes=(100,), budgets_per_host_w=(230.0, 250.0),
        spikes=("flat", "burst", "step", "prime"),
        heterogeneous=(False, True), duration_s=600.0)
    return {"A": (specs_a, ("cpc", "static"), "exact", 3.0),
            "D": (sweep.scenario_families(**DPM_GRID), ("cpc", "static"),
                  "exact", DPM_SLACK),
            "R": (sweep.row_contention_specs(sizes=(10,)),
                  ("cpc", "static"), "buckets", 3.0),
            "pad": (specs_a[:3], ("cpc",), "exact", 3.0)}


def sc_run(grids: dict) -> dict:
    """Each grid on this process's rank(s), ``n_devices=None`` (the world):
    per-cell fields, each bucket's final states, split and loop counts,
    the K1-K8 launches and the wall."""
    from repro_torch.sim import sweep
    out = {}
    for tag, (specs, pols, how, slack) in grids.items():
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "exact":
            res = sweep.run_sweep_batched(specs, pols, slot_slack=slack)
        else:
            res = sweep.run_sweep(specs, pols, engine="batch",
                                  slot_slack=slack)
        wall = time.perf_counter() - t0
        out[tag] = dict(
            cells={(n, p): tuple(getattr(r, f) for f in SC_FIELDS)
                   for n, by in res.items() for p, r in by.items()},
            finals=[(b["result"].final_caps, b["result"].final_on,
                     b["result"].final_occ) for b in sweep.LAST_BATCH_INFO],
            n_devices=[b["n_devices"] for b in sweep.LAST_BATCH_INFO],
            info=[b["info"] for b in sweep.LAST_BATCH_INFO],
            launches=read_launches(), wall_s=wall)
    return out


def sc_rank(grids: dict) -> dict:
    """A rank of path SC."""
    import torch.distributed as dist
    from repro_torch.runtime import sharding
    return dict(runs=sc_run(grids), rank=sharding.rank(),
                backend=dist.get_backend(),
                device=str(sharding.rank_device()))


def sc_shard_launches(grids: dict, tag: str, n: int) -> list:
    """K1's and K2's launches of each of ``n`` contiguous shards of an
    exact grid's cells (the padding's copies of the leading cells
    included) run alone on this process."""
    from repro_torch.sim import sweep
    from repro_torch.sim.batch import BatchedSimulator
    specs, pols, _, slack = grids[tag]
    cells, _ = sweep.build_batch_cells(specs, pols)
    cells = cells + cells[:(-len(cells)) % n]
    per = len(cells) // n
    out = []
    for r in range(n):
        reset_launches()
        BatchedSimulator(cells[r * per:(r + 1) * per], slot_slack=slack,
                         balancer=sweep.grid_balancer(specs)).run()
        launches = read_launches()
        out.append({k: launches[k] for k in ("waterfill_dense",
                                             "balance_caps")})
    return out


def run_sharded_sweep_path() -> tuple[dict, dict]:
    """Path SC: the grids of :func:`sc_grids` split over two ranks that
    share the card (gloo) and on one rank under nccl, each rank a spawned
    process, against the same grids in this process: every per-cell
    count, energy, payload, final placement, power state and cap bitwise
    equal on every rank, each bucket split over ``min(world, cells)``
    ranks, and each rank's K1 and K2 launches those of its shard of the
    cells run alone (cap-only grids through the buckets: K1 a tick, K2 a
    DRS invocation)."""
    from repro_torch.launch import mesh
    grids = sc_grids()
    single = sc_run(grids)
    if len(single["A"]["cells"]) != SC_CELLS:
        raise AssertionError(f"SC: grid A has {len(single['A']['cells'])} "
                             f"cells, its K2 record was planned for "
                             f"{SC_CELLS}")
    shards = {tag: sc_shard_launches(grids, tag, 2)
              for tag, g in grids.items() if g[2] == "exact"}
    torch.cuda.empty_cache()
    worlds = {}
    for world in (2, 1):
        log(mesh_line("cuda", world))
        t0 = time.perf_counter()
        outs = mesh.spawn(sc_rank, world, "cuda", grids,
                          timeout_s=MESH_TIMEOUT_S)
        worlds[world] = (outs, time.perf_counter() - t0)
    info = {"single": {t: dict(wall_s=r["wall_s"]) for t, r in
                       single.items()}}
    for world, (outs, wall) in worlds.items():
        rec = info[f"world{world}"] = dict(spawn_wall_s=wall, ranks=[])
        for o in outs:
            if o["backend"] != mesh.backend_for("cuda", world):
                raise AssertionError(f"SC: rank {o['rank']} ran "
                                     f"{o['backend']}")
            rank_rec = dict(rank=o["rank"], backend=o["backend"],
                            device=o["device"], grids={})
            for tag, run in o["runs"].items():
                want = single[tag]
                bad = [k for k in want["cells"]
                       if run["cells"].get(k) != want["cells"][k]]
                if bad or run["cells"].keys() != want["cells"].keys():
                    raise AssertionError(
                        f"SC {tag} world {world} rank {o['rank']}: cells "
                        f"{bad[:3]} differ from one process's run")
                for fa, fb in zip(run["finals"], want["finals"],
                                  strict=True):
                    if not all(np.array_equal(x, y) for x, y in
                               zip(fa, fb)):
                        raise AssertionError(f"SC {tag} world {world}: "
                                             f"final states differ")
                n_cells = len(want["cells"])
                if max(run["n_devices"]) != min(world, n_cells):
                    raise AssertionError(f"SC {tag}: split "
                                         f"{run['n_devices']}")
                got = {k: run["launches"][k] for k in ("waterfill_dense",
                                                       "balance_caps")}
                if world == 1:
                    exp = {k: want["launches"][k] for k in got}
                elif tag in shards:
                    exp = shards[tag][o["rank"]]
                else:
                    loop = run["info"][0]
                    exp = ({"waterfill_dense": loop["ticks"],
                            "balance_caps": loop["invocation_ticks"]}
                           if loop else dict.fromkeys(got, 0))
                rest = {k: v for k, v in run["launches"].items()
                        if k not in got}
                if got != exp or any(rest.values()):
                    raise AssertionError(f"SC {tag} world {world} rank "
                                         f"{o['rank']}: launches "
                                         f"{run['launches']}, expected "
                                         f"{exp}")
                gather = sum(i.get("gather_s", 0.0) for i in run["info"])
                rank_rec["grids"][tag] = dict(
                    wall_s=run["wall_s"], gather_s=gather,
                    gather_share=gather / run["wall_s"],
                    n_devices=run["n_devices"], launches=got,
                    cells=n_cells)
            rec["ranks"].append(rank_rec)
        log(f"path SC, world {world} ({outs[0]['backend']} on "
            f"{outs[0]['device']}): bitwise equal to one process on every "
            f"grid; spawn wall {wall:.1f} s; "
            + "; ".join(f"{t} {g['wall_s']:.3f} s (gather {g['gather_s']:.3f}"
                        f" s), K1/K2 {g['launches']}" for t, g in
                        rec["ranks"][0]["grids"].items()))
    lead = worlds[2][0][0]["runs"]
    launches = dict(no_model_launches(),
                    waterfill_dense=sum(r["launches"]["waterfill_dense"]
                                        for r in lead.values()),
                    balance_caps=sum(r["launches"]["balance_caps"]
                                     for r in lead.values()),
                    waterfill_segmented=0)
    return launches, info


def me_rank() -> dict:
    """A rank of path ME: one OLMoE-1B-7B MoE layer at full width on a
    ``("data", "model") = (1, 2)`` mesh, each rank 32 of the 64 experts,
    against the dense dispatch on the whole weights on the card, in
    float32 and bf16; raises past a gate."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh
    from repro_torch.models import moe
    from repro_torch.runtime import sharding
    from repro_torch.runtime.sharding import Rules, sharding_context

    cfg = configs.get("olmoe_1b_7b")
    dev = sharding.rank_device()
    m = mesh.make_host_mesh((1, 2), ("data", "model"))
    _, mi = m.get_coordinate()
    rules = Rules(batch=("data",), expert=("model",))
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    f32 = torch.float32
    full32 = {"router": randn((d, e), f32, dev, 70) * d ** -0.5,
              "w_gate": randn((e, d, f), f32, dev, 71) * d ** -0.5,
              "w_up": randn((e, d, f), f32, dev, 72) * d ** -0.5,
              "w_down": randn((e, f, d), f32, dev, 73) * f ** -0.5}
    x32 = randn(ME_TOKENS + (d,), f32, dev, 74)
    probe = randn(ME_TOKENS + (d,), f32, dev, 75)
    out = dict(rank=sharding.rank(), backend=dist.get_backend(),
               device=str(dev), experts=e // 2)
    for dtype in (f32, torch.bfloat16):
        tag = str(dtype)[6:]
        full = {k: v.to(dtype).requires_grad_(True)
                for k, v in full32.items()}
        own = {k: v.detach().clone().requires_grad_(True) for k, v in
               moe.expert_shard({k: v.detach() for k, v in full.items()},
                                cfg, mi, 2).items()}
        xd = x32.to(dtype).requires_grad_(True)
        xe = x32.to(dtype).requires_grad_(True)
        y_d, aux_d = moe._moe_ffn_dense(full, xd, cfg)
        g_d = torch.autograd.grad((y_d.float() * probe).sum() + aux_d,
                                  [xd] + list(full.values()))
        reset_launches()
        with sharding_context(m, rules), \
                timed_collectives(moe, sharding) as coll:
            y_e, aux_e = moe.moe_ffn(own, xe, cfg)
            fwd = read_launches()
            reset_launches()
            g_e = torch.autograd.grad((y_e.float() * probe).sum() + aux_e,
                                      [xe] + list(own.values()))
            bwd = read_launches()
        for what, got, exp in (("forward", fwd, 3), ("backward", bwd, 6)):
            if got != dict(no_model_launches(), grouped_matmul=exp,
                           **dict.fromkeys(KERNELS, 0)):
                raise AssertionError(f"ME {tag} {what}: launches {got}")
        rec = dict(fwd_launches=fwd["grouped_matmul"],
                   bwd_launches=bwd["grouped_matmul"],
                   collective_s=coll[0])
        if dtype == f32:
            err = float((y_e - y_d).detach().abs().max())
            aux = (float(aux_e.detach()), float(aux_d.detach()))
            if not err <= 1e-6 or aux[0] != aux[1]:
                raise AssertionError(f"ME float32: output {err} from the "
                                     f"dense dispatch (bound 1e-6), aux "
                                     f"{aux[0]} vs {aux[1]}")
            sl = slice(mi * (e // 2), (mi + 1) * (e // 2))
            names = ["x"] + list(full)
            grad_errs = {}
            for name, ge, gd in zip(names, g_e, g_d):
                want = gd[sl] if name.startswith("w_") else gd
                grad_errs[name] = rel_l2(ge, want)
                if not grad_errs[name] <= 1e-5:
                    raise AssertionError(f"ME float32: gradient {name} "
                                         f"{grad_errs[name]:.3e} relative "
                                         f"L2 from the dense dispatch")
            rec.update(max_abs_err=err, grad_rel_l2=grad_errs)
        else:
            rec["max_abs_err"] = attn_err(y_e, y_d, dtype, "ME bf16 output")
        with torch.no_grad():
            with sharding_context(m, rules):
                rec["ep_forward_ms"] = time_ms(
                    lambda: moe.moe_ffn(own, xe, cfg))
            rec["dense_forward_ms"] = time_ms(
                lambda: moe._moe_ffn_dense(full, xd, cfg))
        out[tag] = rec
        del full, own, xd, xe, y_d, y_e, g_d, g_e
        torch.cuda.empty_cache()
    return out


def run_expert_parallel_path() -> tuple[dict, dict]:
    """Path ME: :func:`me_rank` on two ranks sharing the card (gloo); each
    rank's K7 launches 3 a forward and 6 a backward."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()
    log(mesh_line("cuda", 2))
    t0 = time.perf_counter()
    outs = mesh.spawn(me_rank, 2, "cuda", timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    for o in outs:
        f, b = o["float32"], o["bfloat16"]
        log(f"path ME rank {o['rank']} ({o['backend']} on {o['device']}, "
            f"{o['experts']} experts): float32 err {f['max_abs_err']:.3e}, "
            f"worst gradient {max(f['grad_rel_l2'].values()):.3e}; bf16 err "
            f"{b['max_abs_err']:.3e}; forward {b['ep_forward_ms']:.3f} ms "
            f"expert-parallel vs {b['dense_forward_ms']:.3f} ms dense "
            f"(bf16), collectives {f['collective_s']:.3f} / "
            f"{b['collective_s']:.3f} s; K7 {b['fwd_launches']} + "
            f"{b['bwd_launches']}")
    lead = outs[0]["bfloat16"]
    launches = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0),
                    grouped_matmul=lead["fwd_launches"]
                    + lead["bwd_launches"])
    return launches, dict(spawn_wall_s=wall, ranks=outs)


def me_k7_record(dev) -> dict:
    """K7 at path ME's local products (32 experts, C 640, bf16: gate and
    up (32, 640, 2048) @ (32, 2048, 1024), down (32, 640, 1024) @ (32,
    1024, 2048)) against its plain version, timed beside it and
    ``torch.bmm``, with its bound; the record is the gate product's."""
    from repro_torch.kernels.moe_gmm import ops, ref
    cases = {}
    for i, (case, (e, c, d, f)) in enumerate((
            ("gate", (32, 640, 2048, 1024)), ("down", (32, 640, 1024, 2048)))):
        x = randn((e, c, d), torch.bfloat16, dev, 80 + i)
        w = (randn((e, d, f), torch.float32, dev, 90 + i)
             * d ** -0.5).to(torch.bfloat16)
        got = ops.grouped_matmul(x, w)
        err = attn_err(got, ref.grouped_matmul_ref(x, w), torch.bfloat16,
                       f"K7 ME {case}")
        if not torch.equal(got, ops.grouped_matmul(x, w)):
            raise AssertionError(f"K7 ME {case}: two launches differ")
        bound, by = bound_ms(2 * (e * c * d + e * d * f + e * c * f),
                             2.0 * e * c * d * f, PEAK_BF16_FLOPS)
        cases[case] = dict(
            shape=[e, c, d, f], max_abs_err=err, bound_ms=bound, bound_by=by,
            ms=time_ms(lambda: ops.grouped_matmul(x, w)),
            plain_ms=time_ms(lambda: ref.grouped_matmul_ref(x, w)),
            library_ms=time_ms(lambda: torch.bmm(x, w)))
        log(f"ME: K7 {case} {e}x{c}x{d}x{f} err {err:.3e} "
            f"{cases[case]['ms']:.4f} ms (plain {cases[case]['plain_ms']:.3f}"
            f" ms, bmm {cases[case]['library_ms']:.4f} ms, bound "
            f"{bound:.4f} ms by {by})")
    g = cases["gate"]
    return dict(name="grouped_matmul 32x640x2048x1024", route="cuda",
                source="src/repro_torch/kernels/moe_gmm/csrc/gmm_tc.cu",
                replaces="src/repro/kernels/moe_gmm/kernel.py:46",
                max_abs_err=max(c["max_abs_err"] for c in cases.values()),
                rtol=ATTN_TOL[torch.bfloat16],
                atol_per_rms=ATTN_TOL[torch.bfloat16], ms=g["ms"],
                plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
                bound_by=g["bound_by"], library_ms=g["library_ms"],
                cases=cases)


def te_attention_records(dev) -> list:
    """K4 and K5 at path TE's layer in float32 (a rank's 2 x 1024 tokens,
    36/36 heads of 64, causal: the CUDA-core kernels, as the plan must
    choose) against their plain versions, timed beside them and SDPA,
    with their bounds over the float32 peak."""
    from repro_torch.kernels.flash_attention import ops, ref
    b, s, h, d = TE_BATCH // 2, TE_SEQ, 36, 64
    q, k, v, do = attn_operands(b, s, s, h, h, d, torch.float32, dev, 500)
    attn_plan(q, k, v, want="cuda_core", what="K4 TE")
    attn_plan(q, k, v, do, "cuda_core", "K5 TE")
    err4 = k4_case(q, k, v, True, 0, "K4 TE float32")
    errs5, (q, k, v, out, lse, do), _ = k5_case(q, k, v, do, True, 0,
                                                "K5 TE float32", True)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    fwd = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    both = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, is_causal=True), (qt, kt, vt), do.transpose(1, 2)))
    bounds = attn_bounds(b, s, s, h, h, d, True, 4)
    shape = f"{b}x{s}x{s}x{h}x{h}x{d}"
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    common = dict(route="cuda", case="TE float32", causal=True,
                  rtol=ATTN_TOL[torch.float32],
                  atol_per_rms=ATTN_TOL[torch.float32], regime="cuda_core")
    k4 = dict(common, name=f"flash_attention {shape}",
              source=src + "flash_fwd.cu",
              replaces="src/repro/kernels/flash_attention/kernel.py:83",
              max_abs_err=err4,
              ms=time_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
              plain_ms=time_ms(lambda: ref.flash_attention_ref(
                  q, k, v, causal=True, block_k=ops.BLOCK_K)),
              bound_ms=bounds["k4"][0], bound_by=bounds["k4"][1],
              library_ms=fwd)
    k5 = dict(common, name=f"flash_attention_bwd {shape}",
              source=src + "flash_bwd.cu",
              replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
              max_abs_err=max(errs5.values()),
              ms=time_ms(lambda: ops.flash_attention_bwd(
                  q, k, v, out, lse, do, causal=True)),
              plain_ms=time_ms(lambda: ref.flash_attention_bwd_ref(
                  q, k, v, out, lse, do, causal=True, block_q=ops.BLOCK_Q,
                  block_k=ops.BLOCK_K)),
              bound_ms=bounds["k5"][0], bound_by=bounds["k5"][1],
              library_ms=both - fwd)
    for r in (k4, k5):
        log(f"TE: {r['name']} float32 err {r['max_abs_err']:.3e} "
            f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f} ms, SDPA "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms)")
    return [k4, k5]


def state_digest(tree) -> list:
    """Per leaf, in path order: the sum, and a position-weighted sum, of
    its bits as integers (int64 on the card, a slice at a time)."""
    from repro_torch.checkpoint.checkpointer import _flatten
    out = []
    for path, leaf in sorted(_flatten(tree).items()):
        if isinstance(leaf, int):
            out.append((path, leaf))
            continue
        bits = leaf.detach().reshape(-1).view(
            {4: torch.int32, 2: torch.int16, 1: torch.int8}[
                leaf.element_size()])
        s = w = 0
        for part in bits.split(1 << 24):
            v = part.to(torch.int64)
            s += int(v.sum())
            w += int((v * (torch.arange(v.numel(), device=v.device)
                           % 1021 + 1)).sum())
        out.append((path, s, w))
    return out


def te_rank(ckpt_dir: str) -> dict:
    """A rank of path TE: MiniCPM-2B at full width and 4 layers in float32
    on a ``("pod", "data") = (2, 1)`` mesh; raises past a gate.  First one
    batch's data-parallel gradients against one rank's (rank 0, 1e-4 a
    leaf, loss 1e-5) and ``compressed_cross_pod_mean`` of each pod's own
    gradients (equal on both ranks, equal to the plain mean of the
    dequantized values); then 3 steps, a resize 2 -> 1 pods
    (``dpm-poweroff``), 3 steps on rank 0 alone, a resize 1 -> 2
    (``dpm-poweron``) and 3 steps, every restored leaf equal to the saved
    one (rank 0 bitwise, rank 1 by its digest) and the data cursor with
    them; then, on rank 0, the same 9 batches unresized on one rank (every
    loss within 1e-5 relative) and the reference example's assertions."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch import mesh, shardspecs
    from repro_torch.optim import compress
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import train_loop
    from repro_torch.runtime import sharding
    from repro_torch.runtime.elastic import ElasticController
    from repro_torch.runtime.sharding import Rules, sharding_context
    from repro_torch.tree import leaves, leaves_with_path

    cfg = dataclasses.replace(configs.get("minicpm_2b"), n_layers=TE_LAYERS,
                              param_dtype="float32")
    dev, r = sharding.rank_device(), sharding.rank()
    opt = AdamW(learning_rate=1e-3)
    rules = Rules(batch=("pod", "data"), heads=None, kv_heads=None,
                  ffn=None, vocab=None, expert=None, fsdp=None, embed_p=None)

    def make_mesh(n_pods):
        return mesh.make_host_mesh((n_pods, 1), ("pod", "data"))

    ctl = ElasticController(
        Checkpointer(ckpt_dir, keep=1), make_mesh,
        lambda m, target: shardspecs.train_state_shardings(cfg, m, rules))
    ck_s = {"save": 0.0, "restore": 0.0}

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            ck_s[name] += time.perf_counter() - t0
            return result
        return call
    ctl.checkpointer.save = timed("save", ctl.checkpointer.save)
    ctl.checkpointer.restore = timed("restore", ctl.checkpointer.restore)
    m = make_mesh(2)
    specs = shardspecs.param_shardings(cfg, m, rules)

    def fresh_state():
        return train_loop.init_train_state(
            cfg, opt, torch.Generator(device=dev).manual_seed(0), dev)

    def stream():
        return SyntheticTokens(cfg.vocab_size, TE_SEQ, TE_BATCH, seed=3,
                               device=dev)

    def as_batch(b):
        return {"tokens": b.tokens, "labels": b.labels,
                "weights": b.weights}

    out = dict(rank=r, backend=dist.get_backend(), device=str(dev))
    state = fresh_state()
    grads_fn = train_loop.make_grads_fn(cfg, grad_shardings=specs)
    first = as_batch(stream().next_batch())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with sharding_context(m, rules), \
            timed_collectives(train_loop) as coll:
        g_dp, met_dp = grads_fn(state.params, first)
    out["dp_grads_s"], out["dp_grads_collective_s"] = (
        time.perf_counter() - t0, coll[0])
    half = TE_BATCH // 2
    own, _ = grads_fn(state.params, {k: v[r * half:(r + 1) * half]
                                     for k, v in first.items()})
    t0 = time.perf_counter()
    means = []
    for g in leaves(own):
        cm = compress.compressed_cross_pod_mean(g, m)
        # Written apart from the port's: every pod's float32 gradient
        # gathered as it is, each quantized to int8 steps and dequantized
        # here, summed in pod order and divided by the pods.
        pods = sharding.all_gather(g.float(), m, "pod")
        plain = torch.zeros_like(cm)
        for x in pods:
            step = x.abs().max() / 127.0 + 1e-30
            plain += torch.clamp(torch.round(x / step), -127, 127) * step
        plain /= pods.shape[0]
        if not torch.equal(cm, plain):
            raise AssertionError(
                f"TE: compressed_cross_pod_mean differs from the plain "
                f"mean of the dequantized values by "
                f"{float((cm - plain).abs().max()):.3e}")
        del pods, plain
        means.append(cm)
    out["cross_pod_mean_s"] = time.perf_counter() - t0
    digests = sharding.all_gather_objects(state_digest({"g": dict(enumerate(
        means))}))
    if digests[0] != digests[1]:
        raise AssertionError("TE: compressed_cross_pod_mean differs "
                             "between the ranks")
    del own, means
    if r == 0:
        g_one, met_one = grads_fn(state.params, first)
        loss_err = abs(float(met_dp["loss"]) - float(met_one["loss"])) / abs(
            float(met_one["loss"]))
        worst = max((rel_l2_sliced(a, b), "/".join(p)) for (p, a), (_, b) in
                    zip(leaves_with_path(g_dp), leaves_with_path(g_one)))
        if not (loss_err <= 1e-5 and worst[0] <= 1e-4):
            raise AssertionError(f"TE: data-parallel loss {loss_err:.3e}, "
                                 f"gradient {worst} from one rank")
        out.update(dp_loss_rel_err=loss_err, dp_worst_grad=worst)
        del g_one
    del g_dp
    torch.cuda.empty_cache()

    step_fn = train_loop.make_train_step(cfg, opt, grad_shardings=specs)
    data = stream()
    losses, phases = [], []

    def run(m, state):
        lost, t0 = [], time.perf_counter()
        reset_launches()
        with timed_collectives(train_loop) as coll:
            for _ in range(TE_STEPS):
                b = as_batch(data.next_batch())
                if state is None:
                    continue
                with sharding_context(m, rules):
                    state, met = step_fn(state, b)
                lost.append(float(met["loss"]))
        torch.cuda.synchronize()
        phases.append(dict(wall_s=time.perf_counter() - t0,
                           collective_s=coll[0], launches=read_launches(),
                           steps=len(lost)))
        return state, lost

    resizes = []
    for frm, to, reason in ((2, 1, "dpm-poweroff"), (1, 2, "dpm-poweron")):
        state, lost = run(m, state)
        losses.append(lost)
        before = state
        t0, ck0 = time.perf_counter(), dict(ck_s)
        m, state = ctl.resize(state, data.step, frm, to, reason,
                              {"data": data.state_dict()})
        wall = time.perf_counter() - t0
        meta = ctl.checkpointer.metadata(data.step)
        if meta["data"] != data.state_dict():
            raise AssertionError(f"TE: data cursor {meta['data']} saved, "
                                 f"{data.state_dict()} in the run")
        if r == 0:
            a, b = _flatten(before), _flatten(state)
            same = sorted(a) == sorted(b) and all(
                a[k] == b[k] if isinstance(a[k], int) else torch.equal(
                    a[k].detach().reshape(-1).view(torch.int32),
                    b[k].detach().reshape(-1).view(torch.int32))
                for k in a)
            if not same:
                raise AssertionError(f"TE: a leaf restored after {reason} "
                                     f"differs from the leaf saved")
        del before
        digest = None if state is None else state_digest(state)
        held = [d for d in sharding.all_gather_objects(digest)
                if d is not None]
        if len(held) != to or any(d != held[0] for d in held):
            raise AssertionError(f"TE: after {reason} {len(held)} ranks hold "
                                 f"the state, their digests differ")
        resizes.append(dict(reason=reason, wall_s=wall,
                            in_mesh=state is not None,
                            **{f"{k}_s": ck_s[k] - ck0[k] for k in ck_s}))
    state, lost = run(m, state)
    losses.append(lost)
    out.update(losses=losses, phases=phases, resizes=resizes,
               history=[(e.step, e.from_pods, e.to_pods, e.reason)
                        for e in ctl.history],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if r != 0:
        return out
    del state
    torch.cuda.empty_cache()
    state, data, want = fresh_state(), stream(), []
    step_one = train_loop.make_train_step(cfg, opt)
    for _ in range(3 * TE_STEPS):
        state, met = step_one(state, as_batch(data.next_batch()))
        want.append(float(met["loss"]))
    got = [x for phase in losses for x in phase]
    errs = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    if len(got) != len(want) or not max(errs) <= 1e-5:
        raise AssertionError(f"TE: losses {got} against one unresized rank's "
                             f"{want}")
    l1, l2, l3 = losses
    if not (l2[0] < l1[0] and l3[-1] < l1[0]):
        raise AssertionError(f"TE: the example's assertions fail: {losses}")
    out.update(single_rank_losses=want, loss_rel_err=max(errs))
    return out


def mesh_path_records(tag: str, dev) -> list:
    """The kernel records of mesh path ``tag`` at the shapes its ranks
    launch: SC's K1 and K2 at a rank's 16 cells of 100 hosts x 10 VMs (K2
    planned for the grid's :data:`SC_CELLS`), ME's K7 at a rank's 32
    experts, TE's K4 and K5 at its float32 layer, ST's and TT's K4, K5
    and K6 at their ranks' heads (:func:`split_attention_records`)."""
    if tag == "SC":
        return check_kernels({"SC": (16, 100, 10, True, 100)}, dev,
                             plan_cells=SC_CELLS)["SC"]
    if tag == "ME":
        return [me_k7_record(dev)]
    if tag in ("ST", "TT"):
        return split_attention_records(tag, dev)
    if tag in ("SQ", "SM", "TS"):
        return part2c_records(tag, dev)
    return te_attention_records(dev)


def run_elastic_path() -> tuple[dict, dict]:
    """Path TE: :func:`te_rank` on two ranks sharing the card (gloo), the
    checkpoints in a temporary directory that is removed; K4 twice and K5
    once a layer a step on each rank that steps (full remat), no other
    kernel."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()
    log(mesh_line("cuda", 2))
    with tempfile.TemporaryDirectory(prefix="te_ckpt_") as tmp:
        t0 = time.perf_counter()
        outs = mesh.spawn(te_rank, 2, "cuda", tmp, timeout_s=MESH_TIMEOUT_S)
        wall = time.perf_counter() - t0
    for o in outs:
        for ph in o["phases"]:
            exp = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0),
                       flash_attention=2 * TE_LAYERS * ph["steps"],
                       flash_attention_bwd=TE_LAYERS * ph["steps"])
            if ph["launches"] != exp:
                raise AssertionError(f"TE rank {o['rank']}: launches "
                                     f"{ph['launches']}, expected {exp}")
    lead = outs[0]
    log(f"path TE ({lead['backend']} on {lead['device']}): losses "
        f"{lead['losses']} (one unresized rank {lead['single_rank_losses']},"
        f" worst {lead['loss_rel_err']:.3e}); data-parallel gradients "
        f"{lead['dp_worst_grad']} from one rank; phases "
        + ", ".join(f"{p['wall_s']:.2f} s (collectives "
                    f"{p['collective_s']:.2f} s)" for p in lead["phases"])
        + "; resizes " + ", ".join(
            f"{z['reason']} {z['wall_s']:.2f} s (save {z['save_s']:.2f} s, "
            f"restore {z['restore_s']:.2f} s)" for z in lead["resizes"])
        + f"; spawn wall {wall:.1f} s, peak {lead['peak_gb']:.2f} GB a rank")
    launches = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
    for ph in lead["phases"]:
        for k in ("flash_attention", "flash_attention_bwd"):
            launches[k] += ph["launches"][k]
    return launches, dict(spawn_wall_s=wall, ranks=outs)


#: Paths ST and TT: tensor parallelism and FSDP storage on two ranks that
#: share the card (gloo).  ST serves granite-8b at 18 of 36 layers in bf16 on
#: ``("pod", "data", "model") = (1, 1, 2)`` with path S's arguments for one
#: replica (8 requests, prompts of 512, 32 greedy tokens, a 1,024-position
#: cache); TT trains granite-8b at full width and 4 of 36 layers, 3 steps
#: of 4 x 4096 tokens, tensor parallel on (1, 1, 2) and ZeRO-3 on
#: (1, 2, 1).  The float32 checks: ST at 4 layers, TT at 2 layers on 4 x
#: 1024 tokens, 2 steps tensor parallel and 1 under ZeRO-3 (every float32
#: gather moves the whole tables through the host).
SPLIT_AXES = ("pod", "data", "model")
ST_BATCH, ST_PROMPT, ST_STEPS, ST_MAX_LEN, ST_F32_LAYERS = 8, 512, 32, 1024, 4
#: ST's bf16 depth (of 36; whole before the sequence layouts' paths).
ST_LAYERS = 18
#: The bar of a split where its direct one cannot hold: no farther from a
#: more exact result of the same parameters on one rank (float32 for a
#: bf16 run, float64 for a float32 leaf of :data:`SPLIT_F64_LEAVES`) than
#: this times one rank's own distance from it.  On an H100 at 700 W the
#: largest bf16 ratio over TT's, TS's and SM's leaves was 1.045 (TS's
#: Mamba2 ``conv_b_b``).
SPLIT_ARM = 1.05
TT_LAYERS, TT_BATCH, TT_SEQ, TT_STEPS = 4, 4, 4096, 3
TT_F32 = dict(layers=2, batch=4, seq=1024, steps={"tp": 2, "zero3": 1})
#: TT's layouts: mesh shape, the ``rules_for`` config change and model axis.
TT_LAYOUTS = {"tp": ((1, 1, 2), "tp", 2), "zero3": ((1, 2, 1), "dp", 1)}


def split_rules(cfg, shape_name: str, model_axis: int, world: int = 2):
    from repro_torch.launch import shardspecs
    from repro_torch.models.config import SHAPES
    return shardspecs.rules_for(cfg, SHAPES[shape_name],
                                model_axis=model_axis, mesh_size=world)


def st_rank() -> dict:
    """A rank of path ST: granite-8b at 18 layers in bf16, then at 4 in
    float32, each served greedily on one rank (each rank runs it: the
    ranks share the card) and then split over ``(1, 1, 2)`` under the
    decode rules (equal to the prefill's here: every head count divides
    2); the split run greedy (timed, its launches counted), teacher-forced
    on one rank's tokens (bf16: logits 1e-2 relative L2), one of its
    decode steps' collectives timed; float32: tokens identical and logits
    1e-5.  Raises past a gate."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh, shardspecs
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.tree import leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = sharding.rank_device()
    m = mesh.make_host_mesh((1, 1, 2), SPLIT_AXES)
    out = dict(rank=sharding.rank(), backend=dist.get_backend(),
               device=str(dev))
    for tag in ("bfloat16", "float32"):
        cfg = dataclasses.replace(configs.get("granite_8b"),
                                  n_layers=ST_LAYERS)
        if tag == "float32":
            cfg = dataclasses.replace(cfg, n_layers=ST_F32_LAYERS,
                                      param_dtype="float32")
        rules = split_rules(cfg, "decode_32k", 2)
        if rules != split_rules(cfg, "prefill_32k", 2):
            raise AssertionError(f"ST: prefill rules {rules} differ from "
                                 f"the decode rules")
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (ST_BATCH, ST_PROMPT), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        with torch.no_grad():
            want_tok, want = generate(cfg, params, prompts, ST_STEPS,
                                      ST_MAX_LEN)
        local = shardspecs.local_params(params, cfg, m, rules)
        del params
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rec = {}
        with torch.no_grad(), sharding_context(m, rules):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, logits = generate(cfg, local, prompts, ST_STEPS,
                                    ST_MAX_LEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rec["launches"] = read_launches()
            # Teacher-forced on one rank's tokens, as generate(forced=)
            # runs it, its third step's collectives timed.
            lg, state = make_prefill_step(cfg, ST_MAX_LEN)(local, prompts)
            decode, seen = make_decode_step(cfg), [lg]
            for i in range(ST_STEPS - 1):
                with timed_collectives(sharding) as coll:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lg, state = decode(local, state, want_tok[:, i])
                    torch.cuda.synchronize()
                if i == 2:
                    step_s, step_coll = time.perf_counter() - t1, coll
                seen.append(lg)
            forced = sharding.gather_dims(torch.stack(seen, 1), m,
                                          ("model",), 2)
        weights_gb = sum(t.numel() * t.element_size()
                         for t in leaves(local)) / 1e9
        rec.update(wall_s=wall, tokens_per_s=ST_BATCH * ST_STEPS / wall,
                   decode_step_s=step_s, step_collective_s=step_coll[0],
                   step_collectives=step_coll[1], weights_gb=weights_gb,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   forced_rel_l2=rel_l2(forced, want),
                   greedy_equal=float((toks == want_tok).float().mean()))
        if not torch.isfinite(logits).all() or logits.shape != want.shape:
            raise AssertionError(f"ST {tag}: logits {logits.shape}")
        if tag == "bfloat16" and not rec["forced_rel_l2"] <= 1e-2:
            raise AssertionError(f"ST bf16: teacher-forced logits "
                                 f"{rec['forced_rel_l2']:.3e} relative L2 "
                                 f"from one rank's (bound 1e-2)")
        if tag == "float32":
            rec["greedy_rel_l2"] = rel_l2(logits, want)
            if not torch.equal(toks, want_tok) or \
                    not rec["greedy_rel_l2"] <= 1e-5:
                raise AssertionError(
                    f"ST float32: tokens equal {rec['greedy_equal']}, "
                    f"logits {rec['greedy_rel_l2']:.3e} relative L2 from "
                    f"one rank's (bounds: identical, 1e-5)")
        out[tag] = rec
        del local, toks, logits, forced, want, state, seen, lg
        torch.cuda.empty_cache()
    return out


def run_split_serving_path() -> tuple[dict, dict]:
    """Path ST: :func:`st_rank` on two ranks sharing the card (gloo); each
    rank's K4 18 (the prefill) and K6 18 x 31 (the decode steps) in the
    greedy run."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()
    log(mesh_line("cuda", 2, "ST (pod, data, model) = (1, 1, 2): heads, "
                  "kv heads, ffn and vocabulary over model"))
    t0 = time.perf_counter()
    outs = mesh.spawn(st_rank, 2, "cuda", timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    n_layers = ST_LAYERS
    want = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0),
                flash_attention=n_layers,
                decode_attention=n_layers * (ST_STEPS - 1))
    for o in outs:
        if o["bfloat16"]["launches"] != want:
            raise AssertionError(f"ST rank {o['rank']}: launches "
                                 f"{o['bfloat16']['launches']}, expected "
                                 f"{want}")
        b, f = o["bfloat16"], o["float32"]
        log(f"path ST rank {o['rank']} ({o['backend']} on {o['device']}): "
            f"{b['tokens_per_s']:.1f} tokens/s ({b['wall_s']:.3f} s for "
            f"{ST_BATCH} x {ST_STEPS}); a decode step {b['decode_step_s']:.4f}"
            f" s, {b['step_collectives']} collectives "
            f"{b['step_collective_s']:.4f} s; weights {b['weights_gb']:.3f} "
            f"GB, peak {b['peak_gb']:.3f} GB; teacher-forced logits "
            f"{b['forced_rel_l2']:.3e} relative L2 from one rank (greedy "
            f"tokens equal {b['greedy_equal']:.3f}); float32 at "
            f"{ST_F32_LAYERS} layers: tokens equal {f['greedy_equal']:.3f}, "
            f"logits {f['greedy_rel_l2']:.3e}")
    launches = dict(outs[0]["bfloat16"]["launches"])
    return launches, dict(spawn_wall_s=wall, ranks=outs)


def tt_batch(cfg, batch: int, seq: int, dev, seed: int) -> dict:
    g = torch.Generator(device=dev).manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                    device=dev, generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (batch, seq),
                                    device=dev, generator=g),
            "weights": torch.ones((batch, seq), dtype=torch.float32,
                                  device=dev)}


def tt_steps(cfg, state, batches, layout=None):
    """AdamW steps over ``batches`` as ``make_train_step`` takes them (the
    gradients, their norm, the update), keeping the first step's
    gradients; ``layout``: the bound context's ``(specs, mesh)``."""
    from repro_torch.optim.adamw import AdamW, global_norm
    from repro_torch.runtime.train_loop import _norm_dims, make_grads_fn
    opt = AdamW(learning_rate=1e-4)
    specs = None if layout is None else layout[0]
    grads_fn = make_grads_fn(cfg, grad_shardings=specs)
    losses, first, walls = [], None, []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, metrics = grads_fn(state.params, batch)
        gnorm = global_norm(grads, _norm_dims(cfg, specs))
        opt.update(grads, state.opt_state, state.params, grad_norm=gnorm)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 0:
            first = grads
        del grads
    return losses, first, walls


#: Paths SQ, SM and TS: the layouts of ``rules_for`` that split the
#: sequence or a Mamba2 mixer's heads, each on two ranks that share the
#: card (gloo), its rules ``rules_for(configs.get(arch), SHAPES[...],
#: mesh_size=256 or 512)`` at the production model axis of 16, bound on
#: the small mesh; sizes as the module's docstring gives them, each cut
#: where a step gathers weights or activations through host memory.
SQ_BATCH, SQ_PROMPT, SQ_MAX_LEN = 8, 512, 1056
#: SQ's MiniCPM-2B depth (of 40) and tokens in bf16 and float32: each
#: decode step gathers the layers' FSDP-stored weights through host
#: memory, about 1.3 s a GB (6.0 GB a step whole: 7.6 s a step on an H100
#: at 700 W, two ranks under gloo); 20 tokens still cross the split at 528.
SQ_RUNS = {"bfloat16": (4, 20), "float32": (2, 18)}
#: SM's Zamba2-7B: one shared-attention site; its layers' weights are
#: gathered over ``data`` every step (1.6 s in bf16, 3.7 s in float32).
SM_ZAMBA = dict(layers=6, prompt=8192, max_len=65536,
                steps={"bfloat16": 4, "float32": 2})
#: SM's Mamba2-2.7B tokens (S's 32 cut to 12).
SM_STEPS = 12
#: TS's depths: every step gathers or reduce-scatters through host memory
#: (InternVL2-26B's Megatron-SP 12 s a layer a step at 4 x 4096).
TS_MODELS = {"minicpm_2b": 2, "internvl2_26b": 1, "mamba2_2p7b": 8}
#: TS's steps: the gates read the first step's gradients and every float32
#: loss, the second after an update.
TS_BATCH, TS_SEQ, TS_STEPS = 4, 4096, 2
TS_F32 = dict(layers=2, seq=1024, steps=2)
#: The float32 leaves held against a float64 gradient where they miss 1e-5:
#: each sums, over every token, terms that mostly cancel (Mamba2's decay
#: rate and its step's bias).
SPLIT_F64_LEAVES = ("blocks/a_log", "blocks/dt_bias")
#: A rank's query offset in TS's MiniCPM layers (rank 1 of 2 over 4,096).
TS_Q_OFFSET = TS_SEQ // 2


def production_rules(cfg, shape_name: str, mesh_size: int):
    from repro_torch.launch import shardspecs
    from repro_torch.models.config import SHAPES
    return shardspecs.rules_for(cfg, SHAPES[shape_name],
                                mesh_size=mesh_size)


def layout_serve(cfg, params, prompts, steps: int, max_len: int, m,
                 prefill_rules, decode_rules, time_step: bool) -> tuple:
    """One rank's run of ``params`` (whole) split over mesh ``m``, teacher
    forced on one rank's greedy tokens (``generate(..., forced=)``; its
    per-step argmax equals them exactly where a greedy run would produce
    them): the prefill under ``prefill_rules`` and the decode steps under
    ``decode_rules`` (``generate``'s ``decode_layout``, the state carried
    by ``relayout_decode_state``), timed with its launches counted; the
    one-rank run comes first, on this rank.  With ``time_step``, three
    more decode steps after a new prefill, the third and its collectives
    timed.  Returns ``(record, tensors)``."""
    from repro_torch.launch import shardspecs
    from repro_torch.runtime import sharding
    from repro_torch.runtime.serve_loop import (generate, make_decode_step,
                                                make_prefill_step)
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.tree import leaves

    with torch.no_grad():
        want_tok, want = generate(cfg, params, prompts, steps, max_len)
    local = shardspecs.local_params(params, cfg, m, prefill_rules)
    same = (shardspecs.param_shardings(cfg, m, prefill_rules)
            == shardspecs.param_shardings(cfg, m, decode_rules))
    dec = local if same else shardspecs.local_params(params, cfg, m,
                                                     decode_rules)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {}
    with torch.no_grad(), sharding_context(m, prefill_rules):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, logits = generate(cfg, local, prompts, steps, max_len,
                                forced=want_tok,
                                decode_layout=(decode_rules, dec))
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = read_launches()
        rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if time_step:
            lg, state = make_prefill_step(cfg, max_len)(local, prompts)
            state = dict(state, cache=shardspecs.relayout_decode_state(
                state["cache"], cfg, m, prefill_rules, decode_rules,
                prompts.shape[0], max_len))
    if time_step:
        decode = make_decode_step(cfg)
        with torch.no_grad(), sharding_context(m, decode_rules):
            for i in range(3):
                with timed_collectives(sharding) as coll:
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    lg, state = decode(dec, state, want_tok[:, i])
                    torch.cuda.synchronize()
            rec["decode_step_s"] = time.perf_counter() - t1
            rec["step_collective_s"], rec["step_collectives"] = coll
        del state, lg
    rec["weights_gb"] = sum(t.numel() * t.element_size()
                            for t in leaves(local)) / 1e9
    rec.update(forced_rel_l2=rel_l2(logits, want),
               greedy_equal=float((toks == want_tok).float().mean()),
               tokens_per_s=prompts.shape[0] * steps / rec["wall_s"])
    if not torch.isfinite(logits).all() or logits.shape != want.shape:
        raise AssertionError(f"logits {tuple(logits.shape)}, one rank's "
                             f"{tuple(want.shape)}")
    return rec, dict(toks=toks, want_tok=want_tok, forced=logits, want=want)


def serve_gate(tag: str, rec: dict, toks: dict, bf16_bar: float | None):
    """bf16: teacher-forced logits within ``bf16_bar`` relative L2 of one
    rank's or, where they are not, no farther from one rank's float32
    logits of the same parameters than :data:`SPLIT_ARM` times one rank's
    own bf16 distance from them (TT's arm: two bf16 computations that
    round apart differ by bf16's noise); float32 (``bf16_bar`` None):
    tokens identical, greedy logits within 1e-5."""
    if bf16_bar is not None and not (
            rec["forced_rel_l2"] <= bf16_bar
            or rec["forced_rel_l2_float32"]
            <= SPLIT_ARM * rec["one_rank_rel_l2_float32"]):
        raise AssertionError(
            f"{tag}: teacher-forced logits {rec['forced_rel_l2']:.3e} "
            f"relative L2 from one rank's (bound {bf16_bar}), "
            f"{rec['forced_rel_l2_float32']:.3e} from one rank's float32 "
            f"against one rank's {rec['one_rank_rel_l2_float32']:.3e}")
    if bf16_bar is None and not (torch.equal(toks["toks"], toks["want_tok"])
                                 and rec["forced_rel_l2"] <= 1e-5):
        raise AssertionError(f"{tag}: tokens equal {rec['greedy_equal']}, "
                             f"logits {rec['forced_rel_l2']:.3e} relative L2 "
                             f"from one rank's (bounds: identical, 1e-5)")


def part2c_serve_rank() -> dict:
    """A rank of paths SQ and SM (see :data:`SQ_BATCH`): each model served
    greedily on one rank and then split, under the production rules'
    prefill and decode layouts, held to ST's and P's gates (bf16 logits
    1e-2 and 2e-2 relative L2 from one rank's, float32 tokens identical
    and logits 1e-5).  Raises past a gate."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import sharding
    from repro_torch.runtime.serve_loop import generate

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = sharding.rank_device()
    out = dict(rank=sharding.rank(), backend=dist.get_backend(),
               device=str(dev))
    model = mesh.make_host_mesh((1, 1, 2), SPLIT_AXES)
    data = mesh.make_host_mesh((1, 2, 1), SPLIT_AXES)
    def sq(dtype):
        return ("prefill_32k", "decode_32k", SQ_BATCH, SQ_PROMPT,
                SQ_MAX_LEN, SQ_RUNS[dtype][1])
    sm = ("prefill_32k", "decode_32k", ST_BATCH, ST_PROMPT, ST_MAX_LEN,
          SM_STEPS)

    def zamba(dtype):
        return ("long_500k", "long_500k", 1, SM_ZAMBA["prompt"],
                SM_ZAMBA["max_len"], SM_ZAMBA["steps"][dtype])
    cases = [
        ("SQ", "minicpm_2b", SQ_RUNS["bfloat16"][0], "bfloat16", model,
         sq("bfloat16"), 1e-2),
        ("SQ", "minicpm_2b", SQ_RUNS["float32"][0], "float32", model,
         sq("float32"), None),
        ("SQ", "granite_8b", 4, "float32", model, sq("bfloat16"), None),
        ("SM", "mamba2_2p7b", None, "bfloat16", model, sm, 2e-2),
        ("SM", "mamba2_2p7b", 4, "float32", model, sm, None),
        ("SM", "zamba2_7b", SM_ZAMBA["layers"], "bfloat16", data,
         zamba("bfloat16"), 2e-2),
        ("SM", "zamba2_7b", SM_ZAMBA["layers"], "float32", data,
         zamba("float32"), None)]
    for tag, arch, layers, dtype, m, shape, bar in cases:
        pre, dec, b, prompt, max_len, steps = shape
        base = configs.get(arch)
        cfg = dataclasses.replace(base, param_dtype=dtype, **(
            {} if layers is None else {"n_layers": layers}))
        t0 = time.perf_counter()
        params = tfm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (b, prompt), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        prules = production_rules(base, pre, 256)
        drules = production_rules(base, dec, 256)
        rec, toks = layout_serve(cfg, params, prompts, steps, max_len, m,
                                 prules, drules,
                                 dtype == "bfloat16" and arch != "zamba2_7b")
        if bar is not None and rec["forced_rel_l2"] > bar:
            # One rank's float32 logits of the same parameters, teacher
            # forced on its bf16 tokens: how far each bf16 run is from them.
            p32 = {g: {k: v.float() for k, v in node.items()}
                   for g, node in params.items()}
            with torch.no_grad():
                _, exact = generate(dataclasses.replace(
                    cfg, param_dtype="float32"), p32, prompts, steps,
                    max_len, forced=toks["want_tok"])
            del p32
            rec["forced_rel_l2_float32"] = rel_l2(toks["forced"], exact)
            rec["one_rank_rel_l2_float32"] = rel_l2(toks["want"], exact)
            del exact
        del params
        toks.pop("forced"), toks.pop("want")
        if out["rank"] == 0:
            log(f"{tag} {arch} {dtype} at {cfg.n_layers} layers: "
                f"teacher-forced logits {rec['forced_rel_l2']:.3e} (argmax "
                f"equal {rec['greedy_equal']:.3f}; from float32 "
                f"{rec.get('forced_rel_l2_float32')}, one rank's "
                f"{rec.get('one_rank_rel_l2_float32')}), "
                f"{rec['wall_s']:.2f} s for {steps} tokens, a decode step "
                f"{rec.get('decode_step_s')} s")
        serve_gate(f"{tag} {arch} {dtype}", rec, toks, bar)
        rec.update(case_s=time.perf_counter() - t0, layers=cfg.n_layers,
                   steps=steps)
        out[tag, arch, dtype] = rec
        torch.cuda.empty_cache()
        sharding.barrier()
    return out


def part2c_serve_launches(arch: str, layers: int, steps: int) -> dict:
    """A rank's model-kernel launches in one split greedy run of ``steps``
    tokens: K4 a layer at prefill, K6 a layer a decode
    step (a Mamba2 layer: K8 at prefill, the plain recurrence after;
    Zamba2: K8 a layer, K4 and K6 at its shared-attention sites)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(arch), n_layers=layers)
    n = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
    sites = (cfg.n_layers // cfg.attn_every if cfg.family == "hybrid"
             else 0 if cfg.family == "ssm" else cfg.n_layers)
    n["flash_attention"] = sites
    n["decode_attention"] = sites * (steps - 1)
    if cfg.family in ("ssm", "hybrid"):
        n["ssd_scan"] = cfg.n_layers
    return n


def run_part2c_serving_paths() -> tuple[dict, dict, dict]:
    """Paths SQ and SM: :func:`part2c_serve_rank` on two ranks sharing the
    card (gloo), exact launch counts; returns SQ's and SM's launches (the
    bf16 runs of rank 0) and the spawn's record."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()
    log(mesh_line("cuda", 2, "SQ (1, 1, 2) sequence over model at prefill, "
                  "the cache's positions over model at decode; SM (1, 1, 2) "
                  "a Mamba2 mixer's heads over model, then (1, 2, 1) "
                  "long_500k's cache positions over data"))
    t0 = time.perf_counter()
    outs = mesh.spawn(part2c_serve_rank, 2, "cuda", timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = {"SQ": dict(no_model_launches(), **dict.fromkeys(KERNELS, 0)),
                "SM": dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))}
    for o in outs:
        for key, rec in o.items():
            if not isinstance(key, tuple):
                continue
            tag, arch, dtype = key
            want = part2c_serve_launches(arch, rec["layers"], rec["steps"])
            if rec["launches"] != want:
                raise AssertionError(f"{tag} {arch} {dtype} rank "
                                     f"{o['rank']}: launches "
                                     f"{rec['launches']}, expected {want}")
            if o["rank"] == 0 and dtype == "bfloat16":
                for k, v in rec["launches"].items():
                    launches[tag][k] += v
            log(f"path {tag} {arch} {dtype} at {rec['layers']} layers rank "
                f"{o['rank']} ({o['backend']} on {o['device']}): "
                f"{rec['tokens_per_s']:.1f} tokens/s ({rec['wall_s']:.3f} s "
                f"for {rec['steps']} tokens); a decode step "
                f"{rec.get('decode_step_s')} s, "
                f"{rec.get('step_collectives')} collectives "
                f"{rec.get('step_collective_s')} s; weights "
                f"{rec['weights_gb']:.3f} GB, peak {rec['peak_gb']:.3f} GB; "
                f"teacher-forced logits {rec['forced_rel_l2']:.3e} relative "
                f"L2 from one rank (argmax equal {rec['greedy_equal']:.3f}; "
                f"from float32 {rec.get('forced_rel_l2_float32')}, one "
                f"rank's {rec.get('one_rank_rel_l2_float32')}); case "
                f"{rec['case_s']:.1f} s")
    info = dict(spawn_wall_s=wall, ranks=[
        {"/".join(k) if isinstance(k, tuple) else k: v for k, v in o.items()}
        for o in outs])
    return launches["SQ"], launches["SM"], info


def ts_batch(cfg, batch: int, seq: int, dev, seed: int) -> dict:
    """TT's batch, with the frontend's stand-ins and ``seq`` rows in all
    (a VLM's text the rows its prefix leaves)."""
    from repro_torch.launch import inputs
    from repro_torch.models.config import ShapeConfig
    specs = inputs.train_batch_specs(cfg, ShapeConfig("TS", "train", seq,
                                                      batch))
    out = tt_batch(cfg, batch, specs["tokens"].shape[1], dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 100)
    out.update({k: inputs.draw(s, g) for k, s in specs.items()
                if k not in out})
    return out


def split_train_cases(path: str) -> list:
    """The runs of path ``path`` (``"TT"`` or ``"TS"``) in order, each a
    dict: ``key``, the effective ``cfg``, ``rules``, ``mesh`` shape, the
    batch maker, ``batch``, ``seq`` and ``steps``, and whether a rank's
    peak must stay below one rank's (ZeRO-3 in bf16).  TT: granite-8b
    under each of :data:`TT_LAYOUTS`, bf16 then float32; TS: each of
    :data:`TS_MODELS` under ``train_4k``'s rules at 512 chips on (1, 1, 2),
    bf16 then float32 in one microbatch (two ranks' float32 states of
    InternVL2-26B, its two 92,553-row tables whole on each, and a float32
    accumulator beside the gradients do not fit a card)."""
    from repro_torch import configs
    from repro_torch.launch import shardspecs
    from repro_torch.models.config import SHAPES
    cases = []
    if path == "TT":
        for name, (shape, parallelism, model_axis) in TT_LAYOUTS.items():
            for dtype, n_layers, batch, seq, steps in (
                    ("bfloat16", TT_LAYERS, TT_BATCH, TT_SEQ, TT_STEPS),
                    ("float32", TT_F32["layers"], TT_F32["batch"],
                     TT_F32["seq"], TT_F32["steps"][name])):
                base = dataclasses.replace(
                    configs.get("granite_8b"), n_layers=n_layers,
                    param_dtype=dtype, parallelism=parallelism)
                cases.append(dict(
                    key=(name, dtype), rules=split_rules(base, "train_4k",
                                                         model_axis),
                    cfg=shardspecs.effective_config(base, SHAPES["train_4k"],
                                                    2),
                    mesh=shape, make_batch=tt_batch, batch=batch, seq=seq,
                    steps=steps, peak_below_one_rank=(
                        name == "zero3" and dtype == "bfloat16")))
        return cases
    for arch, n_layers in TS_MODELS.items():
        base = configs.get(arch)
        rules = production_rules(base, "train_4k", 512)
        for dtype, layers, seq, steps in (
                ("bfloat16", n_layers, TS_SEQ, TS_STEPS),
                ("float32", min(n_layers, TS_F32["layers"]), TS_F32["seq"],
                 TS_F32["steps"])):
            cfg = dataclasses.replace(base, n_layers=layers,
                                      param_dtype=dtype, **(
                                          {} if dtype == "bfloat16"
                                          else {"microbatches": 1}))
            cases.append(dict(key=(arch, dtype), cfg=cfg, rules=rules,
                              mesh=(1, 1, 2), make_batch=ts_batch,
                              batch=TS_BATCH, seq=seq, steps=steps,
                              peak_below_one_rank=False))
    return cases


def split_train_rank(path: str) -> dict:
    """A rank of path TT or TS, each run of :func:`split_train_cases` in
    turn: rank 0 first runs the first step (float32: every step) on one
    rank, its peak memory kept; then both ranks run the steps on their
    blocks, and the first step's gradients are gathered whole.  Float32:
    the losses within 1e-5 relative of one rank's and every gradient leaf
    within 1e-5 relative L2, but for a leaf of :data:`SPLIT_F64_LEAVES`
    past it: no farther from one rank's float64 gradient
    (:func:`mamba2_f64_grads`) than :data:`SPLIT_ARM` times one rank's
    float32 distance from it (those leaves sum long chains of cancelling
    terms).  Bf16: each leaf within T's 4.9e-3 of one rank's or, where it
    is not, no farther from one rank's float32 gradient of the same
    parameters than :data:`SPLIT_ARM` times one rank's own bf16 distance
    from it (two bf16 computations that round their partial sums
    differently differ by bf16's noise, ``tools/tp_rounding.py``).  Where
    a run asks, a rank's peak below one rank's.  Raises past a gate."""
    import torch.distributed as dist
    from repro_torch.launch import mesh, shardspecs
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime import sharding
    from repro_torch.runtime.sharding import gather_whole, sharding_context
    from repro_torch.runtime.train_loop import (init_train_state,
                                                make_grads_fn)
    from repro_torch.tree import leaves, leaves_with_path, map_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    dev, r = sharding.rank_device(), sharding.rank()
    out = dict(rank=r, backend=dist.get_backend(), device=str(dev))

    def errors(got: dict, want: dict) -> dict:
        """Relative L2 a leaf, on the card a leaf at a time."""
        flat = dict(leaves_with_path(want))
        return {"/".join(p): rel_l2(g.to(dev), flat[p].to(dev))
                for p, g in got.items()}

    for case in split_train_cases(path):
        cfg, rules, steps = case["cfg"], case["rules"], case["steps"]
        dtype = case["key"][1]
        m = mesh.make_host_mesh(case["mesh"], SPLIT_AXES)
        batches = [case["make_batch"](cfg, case["batch"], case["seq"], dev,
                                      10 + i) for i in range(steps)]
        rec = dict(microbatches=cfg.microbatches, layers=cfg.n_layers,
                   steps=steps, family=cfg.family, phase_s={})
        phase = rec["phase_s"]

        def fresh():
            return init_train_state(
                cfg, AdamW(learning_rate=1e-4),
                torch.Generator(device=dev).manual_seed(0), dev)
        t0 = time.perf_counter()
        if r == 0:
            state = fresh()
            torch.cuda.reset_peak_memory_stats()
            want_losses, want, _ = tt_steps(
                cfg, state, batches[:1] if dtype == "bfloat16" else batches)
            rec["one_rank_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            want = map_tree(lambda g: g.cpu(), want)       # off the card
            del state
            torch.cuda.empty_cache()
        sharding.barrier()
        phase["one_rank"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = fresh()
        specs = shardspecs.param_shardings(cfg, m, rules)
        local = shardspecs.local_train_state(whole, cfg, m, rules)
        del whole
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with sharding_context(m, rules), timed_collectives(sharding) as coll:
            reset_launches()
            losses, first, walls = tt_steps(cfg, local, batches, (specs, m))
            rec["launches"] = read_launches()
            rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        phase["split"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec.update(losses=losses, step_s=walls, collective_s=coll[0],
                   collectives=coll[1],
                   tokens_per_s=case["batch"] * case["seq"] * steps
                   / sum(walls),
                   block_gb=sum(t.numel() * t.element_size()
                                for t in leaves(local.params)) / 1e9)
        del local
        torch.cuda.empty_cache()
        flat, split = dict(leaves_with_path(specs)), {}
        for p, g in leaves_with_path(first):
            g = gather_whole(g, flat[p], m)
            if r == 0:
                split[p] = g
            del g
        del first
        torch.cuda.empty_cache()
        if r == 0:
            bar = 4.9e-3 if dtype == "bfloat16" else 1e-5
            direct = errors(split, want)
            over = {k: e / bar for k, e in direct.items()}
            rec["grad_rel_l2"] = direct
            if dtype == "bfloat16" and max(over.values()) > 1.0:
                # One rank's float32 gradient of the same parameters.
                p32 = map_tree(lambda t: t.detach().float()
                               .requires_grad_(True), fresh().params)
                exact, _ = make_grads_fn(dataclasses.replace(
                    cfg, param_dtype="float32"))(p32, batches[0])
                exact = map_tree(lambda g: g.cpu(), exact)
                del p32
                torch.cuda.empty_cache()
                hi = errors(split, exact)
                one = errors(dict(leaves_with_path(want)), exact)
                rec.update(grad_rel_l2_float32=hi,
                           one_rank_rel_l2_float32=one)
                over = {k: min(e, hi[k] / (SPLIT_ARM * one[k]))
                        for k, e in over.items()}
                del exact
            named = [k for k in SPLIT_F64_LEAVES if over.get(k, 0.0) > 1.0]
            if dtype == "float32" and named and cfg.family == "ssm":
                exact = mamba2_f64_grads(fresh().params, batches[0], cfg)
                torch.cuda.empty_cache()
                hi = errors(split, exact)
                one = errors(dict(leaves_with_path(want)), exact)
                # Not gated: one rank's gradient summed as two halves, how
                # far another float32 order of the same sums lands.
                _, halves, _ = tt_steps(dataclasses.replace(
                    cfg, microbatches=2), fresh(), batches[:1])
                halves = errors(dict(leaves_with_path(halves)), exact)
                rec.update(grad_rel_l2_float64=hi,
                           one_rank_rel_l2_float64=one,
                           one_rank_halves_rel_l2_float64=halves)
                for k in named:
                    over[k] = min(over[k], hi[k] / (SPLIT_ARM * one[k]))
                del exact
            worst = max(over, key=over.get)
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, want_losses))
            rec.update(grad_rel_l2_worst=(worst, direct[worst]),
                       gate_ratio=over[worst], one_rank_losses=want_losses,
                       loss_rel_err=loss_err)
            log(f"{path} {case['key'][0]} {dtype} at {cfg.n_layers} layers: "
                f"steps {walls} s, losses {losses} (one rank "
                f"{want_losses}), gradients worst {worst} "
                f"{direct[worst]:.3e} (gate ratio {over[worst]:.3f})" + "".join(
                    f"; {k} from float64: split {hi[k]:.3e}, one rank "
                    f"{one[k]:.3e}, one rank in halves {halves[k]:.3e}"
                    for k in named if "grad_rel_l2_float64" in rec))
            if not over[worst] <= 1.0:
                more = {"bfloat16": ("float32", "grad_rel_l2_float32",
                                     "one_rank_rel_l2_float32"),
                        "float32": ("float64", "grad_rel_l2_float64",
                                    "one_rank_rel_l2_float64")}[dtype]
                raise AssertionError(
                    f"{path} {case['key']}: first step's gradient {worst} "
                    f"{direct[worst]:.3e} relative L2 from one rank's "
                    f"(bound {bar})" + (
                        f", {rec[more[1]][worst]:.3e} from one rank's "
                        f"{more[0]} against one rank's "
                        f"{rec[more[2]][worst]:.3e}"
                        if worst in rec.get(more[1], {}) else ""))
            if dtype == "float32" and not loss_err <= 1e-5:
                raise AssertionError(f"{path} {case['key']}: losses "
                                     f"{losses} against one rank's "
                                     f"{want_losses}")
            if case["peak_below_one_rank"] and \
                    not rec["peak_gb"] < rec["one_rank_peak_gb"]:
                raise AssertionError(
                    f"{path} {case['key']}: peak {rec['peak_gb']:.3f} GB a "
                    f"rank, not below one rank's "
                    f"{rec['one_rank_peak_gb']:.3f} GB")
            del want, split
        phase["check"] = time.perf_counter() - t0
        out[case["key"]] = rec
        sharding.barrier()
    return out


def run_split_training_path(path: str) -> tuple[dict, dict]:
    """Path TT or TS: :func:`split_train_rank` on two ranks sharing the
    card (gloo); exact launches in each bf16 run, a layer a microbatch a
    step: an attention layer's K4 twice (forward and the checkpoint's
    recompute) and K5 once, a Mamba2 layer's K8 twice and K8b once.
    Returns rank 0's bf16 launches and the spawn's record."""
    from repro_torch.launch import mesh
    torch.cuda.empty_cache()
    log(mesh_line("cuda", 2, {
        "TT": "TT tensor parallel (1, 1, 2) (heads, ffn, vocabulary over "
              "model), then ZeRO-3 (1, 2, 1) (batch and parameter storage "
              "over data)",
        "TS": "TS (1, 1, 2) train_4k's rules at 512 chips: MiniCPM-2B's "
              "sequence over model (seq, inner_seq), InternVL2-26B's "
              "Megatron-SP, Mamba2-2.7B's heads"}[path]))
    t0 = time.perf_counter()
    outs = mesh.spawn(split_train_rank, 2, "cuda", path,
                      timeout_s=MESH_TIMEOUT_S)
    wall = time.perf_counter() - t0
    launches = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
    runs = [k for k in outs[0] if isinstance(k, tuple)]
    for o in outs:
        for key in runs:
            rec = o[key]
            if key[1] != "bfloat16":
                continue
            per = rec["layers"] * rec["microbatches"] * rec["steps"]
            exp = dict(no_model_launches(), **dict.fromkeys(KERNELS, 0))
            if rec["family"] == "ssm":
                exp.update(ssd_scan=2 * per, ssd_scan_bwd=per)
            else:
                exp.update(flash_attention=2 * per, flash_attention_bwd=per)
            if rec["launches"] != exp:
                raise AssertionError(f"{path} {key[0]} rank {o['rank']}: "
                                     f"launches {rec['launches']}, expected "
                                     f"{exp}")
            if o["rank"] == 0:
                for k, v in rec["launches"].items():
                    launches[k] += v
    lead = outs[0]
    for key in runs:
        if key[1] != "bfloat16":
            continue
        b, f = lead[key], lead[key[0], "float32"]
        worst = b["grad_rel_l2_worst"][0]
        hi = b.get("grad_rel_l2_float32", {}).get(worst)
        one = b.get("one_rank_rel_l2_float32", {}).get(worst)
        log(f"path {path} {key[0]} at {b['layers']} layers ({lead['backend']} "
            f"on {lead['device']}): steps "
            f"{', '.join(f'{x:.3f}' for x in b['step_s'])} s "
            f"({b['tokens_per_s']:.1f} tokens/s a rank's view), collectives "
            f"{b['collective_s']:.2f} s in {b['collectives']} calls; losses "
            f"{b['losses']} (one rank's first {b['one_rank_losses']}); "
            f"first-step gradients worst {b['grad_rel_l2_worst']} (from "
            f"float32 {hi}, one rank's {one}); phases {b['phase_s']}, "
            f"float32 {f['phase_s']}; peak {outs[0][key]['peak_gb']:.3f} / "
            f"{outs[1][key]['peak_gb']:.3f} GB a rank (one rank "
            f"{b['one_rank_peak_gb']:.3f} GB), blocks {b['block_gb']:.3f} "
            f"GB; float32 at {f['layers']} layers, {f['steps']} steps: "
            f"gradients worst {f['grad_rel_l2_worst']} (gate ratio "
            f"{f['gate_ratio']:.3f}), losses {f['loss_rel_err']:.3e}")
    return launches, dict(spawn_wall_s=wall, ranks=[
        {f"{k[0]}/{k[1]}" if isinstance(k, tuple) else k: v
         for k, v in o.items()} for o in outs])


def mamba2_f64_grads(params: dict, batch: dict, cfg) -> dict:
    """One rank's gradient of a Mamba2 model's training loss in float64,
    written apart from the port's modules: the pre-norm residual stack of
    SSD mixers (separate z, x, B, C and dt projections, the depthwise
    causal convs with SiLU, the gated RMSNorm over ``d_inner``), the SSD as
    its quadratic form, ``y_t = sum over s <= t of (C_t . B_s) exp(sum over
    s < k <= t of dt_k A) dt_s x_s`` with ``A = -exp(a_log)``, the tied
    unembedding and the token-weighted cross entropy, differentiated by
    autograd on ``params``' device.  ``params``: the whole float32 tree,
    upcast; one microbatch.  Returns the gradient tree, on the CPU."""
    import torch.nn.functional as F
    from repro_torch.tree import map_tree
    p = map_tree(lambda t: t.detach().double().requires_grad_(True), params)
    tokens, labels = batch["tokens"], batch["labels"]
    weights = batch["weights"].double()
    bsz, l = tokens.shape
    nh, hp, eps = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.norm_eps
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool,
                                   device=tokens.device))[None, :, :, None]

    def rms(x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale

    def conv(x, w, b):
        ctx = F.pad(x, (0, 0, w.shape[0] - 1, 0))
        return F.silu(sum(ctx[:, i:i + l] * w[i] for i in range(w.shape[0]))
                      + b)

    table = p["embed"]["table"]
    h = table[tokens]
    for i in range(cfg.n_layers):
        w = {k: v[i] for k, v in p["blocks"].items()}
        x = rms(h, w["ln"])
        z = x @ w["in_z"]
        xs = conv(x @ w["in_x"], w["conv_x_w"], w["conv_x_b"])
        bm = conv(x @ w["in_b"], w["conv_b_w"], w["conv_b_b"])
        cm = conv(x @ w["in_c"], w["conv_c_w"], w["conv_c_b"])
        dt = F.softplus(x @ w["in_dt"] + w["dt_bias"])           # (B, L, H)
        cum = torch.cumsum(dt * -torch.exp(w["a_log"]), dim=1)
        seg = cum[:, :, None] - cum[:, None]                      # (B, t, s, H)
        decay = torch.exp(torch.where(causal, seg, float("-inf")))
        gram = torch.einsum("btn,bsn->bts", cm, bm)
        xh = xs.reshape(bsz, l, nh, hp)
        y = torch.einsum("btsh,bshp->bthp",
                         gram[..., None] * decay * dt[:, None], xh)
        y = (y + xh * w["d_skip"][:, None]).reshape(bsz, l, nh * hp)
        h = h + rms(y * F.silu(z), w["norm_scale"]) @ w["out_proj"]
        del seg, decay, gram
    logits = rms(h, p["final_norm"]["scale"]) @ table.T
    xent = (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[..., None])[..., 0])
    loss = (xent * weights).sum() / weights.sum().clamp_min(1.0)
    loss.backward()
    return map_tree(lambda t: t.grad.cpu(), p)


def k6_lse_record(tag: str, b: int, s: int, hq: int, hkv: int, d: int,
                  dev, seed: int) -> dict:
    """K6's log-sum-exp entry at a rank's block of a path's cache (``s``
    positions), its rows' ``kv_len`` cycling 0, 1 and ``s``, in float32
    and bf16: the output equal bit for bit to ``decode_attention``'s (cast
    to its dtype), within ``attn_close`` of the plain version
    (``decode_attention_lse_ref``), each log-sum-exp within 1e-6 of the
    plain one's (relative, at least 1e-6 absolute; an empty row exactly
    -1e30), no NaN, two launches bitwise equal; timed beside the plain
    version and SDPA, with its bound."""
    from repro_torch.kernels.decode_attention import ops, ref
    errs = {}
    lens = torch.tensor([(0, 1, s)[i % 3] for i in range(b)],
                        dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = randn((b, hq, d), dtype, dev, seed)
        k, v = (randn((b, s, hkv, d), dtype, dev, seed + 1 + i)
                for i in range(2))
        what = f"K6 lse {tag} {dtype}"
        p = k6_plan(q, k, v, what)
        out, lse = ops.decode_attention_lse(q, k, v, lens)
        pout, plse = ref.decode_attention_lse_ref(q, k, v, lens, ops.BLOCK_K)
        if torch.isnan(out).any() or torch.isnan(lse).any():
            raise AssertionError(f"{what}: NaN")
        if not torch.equal(out.to(dtype), ops.decode_attention(q, k, v,
                                                               lens)):
            raise AssertionError(f"{what}: the output differs from "
                                 f"decode_attention's")
        again = ops.decode_attention_lse(q, k, v, lens)
        if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])):
            raise AssertionError(f"{what}: two launches differ")
        empty = lens == 0
        if not (lse[empty] == ref.NEG_INF).all() or out[empty].any():
            raise AssertionError(f"{what}: an empty row's lse or output")
        lse_err = float(((lse - plse).abs()
                         / plse.abs().clamp_min(1.0))[~empty].max())
        if not lse_err <= 1e-6:
            raise AssertionError(f"{what}: log-sum-exp {lse_err:.3e} from "
                                 f"the plain version's (bound 1e-6)")
        errs[dtype] = (attn_err(out, pout, dtype, what), lse_err)
    times = time_k6(q, k, v, lens)
    times["ms"] = time_ms(lambda: ops.decode_attention_lse(q, k, v, lens))
    times["plain_ms"] = time_ms(lambda: ref.decode_attention_lse_ref(
        q, k, v, lens, ops.BLOCK_K))
    log(f"{tag}: K6 lse {b}x{s}x{hq}x{hkv}x{d} kv_len 0/1/{s} (split "
        f"{p.split}) err {errs[torch.bfloat16][0]:.3e}, lse "
        f"{errs[torch.bfloat16][1]:.3e} (float32 {errs[torch.float32][0]:.3e}"
        f", lse {errs[torch.float32][1]:.3e}) {times['ms']:.4f} ms (plain "
        f"{times['plain_ms']:.3f} ms, SDPA {times['library_ms']:.4f} ms, "
        f"bound {times['bound_ms']:.5f} ms)")
    rec = k6_record((b, s, hq, d), errs[torch.bfloat16][0],
                    errs[torch.float32][0], p, times, entry="lse",
                    lse_max_rel_err=errs[torch.bfloat16][1],
                    float32_lse_max_rel_err=errs[torch.float32][1])
    rec["name"] = f"decode_attention lse {b}x{s}x{hq}x{d}"
    return rec


def k5_offset_records(tag: str, b, sq, skv, hq, hkv, d, q_offset, dev
                      ) -> list:
    """K4 and K5 at a rank's block of queries ``q_offset`` into a causal
    sequence of ``skv`` keys (TS's rank 1), in bf16 (the tensor cores,
    two launches bitwise equal) and float32 (the CUDA cores), against
    their plain versions (``attn_close``); the bf16 calls timed beside
    the plain versions and SDPA with the same mask, with their bounds
    (the pairs the mask keeps: ``Sq q_offset + Sq (Sq + 1) / 2``)."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "src/repro_torch/kernels/flash_attention/csrc/"
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        want = "tensor_core" if dtype == torch.bfloat16 else "cuda_core"
        q, k, v, do = attn_operands(b, sq, skv, hq, hkv, d, dtype, dev, 900)
        attn_plan(q, k, v, want=want, what=f"K4 {tag} offset")
        attn_plan(q, k, v, do, want, f"K5 {tag} offset")
        errs["k4", dtype] = k4_case(q, k, v, True, q_offset,
                                    f"K4 {tag} offset {dtype}")
        e, timed, _ = k5_case(q, k, v, do, True, q_offset,
                              f"K5 {tag} offset {dtype}",
                              bitwise=want == "tensor_core")
        errs["k5", dtype] = max(e.values())
    q, k, v, out, lse, do = timed
    mask = (torch.arange(skv, device=dev)[None, :]
            <= q_offset + torch.arange(sq, device=dev)[:, None])
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gqa = hq != hkv
    fwd_ms = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                  enable_gqa=gqa))
    both_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qt, kt, vt, attn_mask=mask, enable_gqa=gqa), (qt, kt, vt),
        do.transpose(1, 2)))
    pairs = sq * q_offset + sq * (sq + 1) // 2
    el = 2
    k4b = bound_ms(el * (2 * b * sq * hq * d + 2 * b * skv * hkv * d)
                   + 4 * b * hq * sq, 4 * b * hq * d * pairs,
                   PEAK_BF16_FLOPS)
    k5b = bound_ms(el * (4 * b * sq * hq * d + 4 * b * skv * hkv * d)
                   + 8 * b * hq * sq, 10 * b * hq * d * pairs,
                   PEAK_BF16_FLOPS)
    k4_ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True,
                                                q_offset=q_offset))
    k4_pms = time_ms(lambda: ref.flash_attention_ref(
        q, k, v, causal=True, q_offset=q_offset, block_k=ops.BLOCK_K))
    k5_ms = time_ms(lambda: ops.flash_attention_bwd(
        q, k, v, out, lse, do, causal=True, q_offset=q_offset))
    k5_pms = time_ms(lambda: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, do, causal=True, q_offset=q_offset,
        block_q=ops.BLOCK_Q, block_k=ops.BLOCK_K))
    shape = f"{b}x{sq}x{skv}x{hq}x{hkv}x{d}"
    common = dict(route="cuda", case=f"q_offset {q_offset}", causal=True,
                  q_offset=q_offset, rtol=ATTN_TOL[torch.bfloat16],
                  atol_per_rms=ATTN_TOL[torch.bfloat16])
    log(f"{tag}: K4 / K5 {shape} at q_offset {q_offset} err "
        f"{errs['k4', torch.bfloat16]:.3e} / {errs['k5', torch.bfloat16]:.3e}"
        f" (float32 {errs['k4', torch.float32]:.3e} / "
        f"{errs['k5', torch.float32]:.3e}) {k4_ms:.4f} / {k5_ms:.4f} ms "
        f"(plain {k4_pms:.3f} / {k5_pms:.3f} ms, SDPA {fwd_ms:.4f} / "
        f"{both_ms - fwd_ms:.4f} ms, bound {k4b[0]:.4f} / {k5b[0]:.4f} ms)")
    return [
        dict(common, name=f"flash_attention {shape}",
             source=src + "flash_fwd_tc.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:83",
             max_abs_err=errs["k4", torch.bfloat16],
             float32_max_abs_err=errs["k4", torch.float32], ms=k4_ms,
             plain_ms=k4_pms, bound_ms=k4b[0], bound_by=k4b[1],
             library_ms=fwd_ms),
        dict(common, name=f"flash_attention_bwd {shape}",
             source=src + "flash_bwd_tc.cu",
             replaces="src/repro/kernels/flash_attention/kernel_bwd.py:125",
             max_abs_err=errs["k5", torch.bfloat16],
             float32_max_abs_err=errs["k5", torch.float32], ms=k5_ms,
             plain_ms=k5_pms, bound_ms=k5b[0], bound_by=k5b[1],
             library_ms=both_ms - fwd_ms)]


def part2c_records(tag: str, dev) -> list:
    """The kernel records of path ``tag`` at the shapes its ranks launch:
    SQ's K4 on rank 1's block of MiniCPM-2B's prefill (8 x 256 queries at
    offset 256 over 512 keys, 36 heads of 64) and K6's lse entry on a
    rank's block of its cache (528 of 1,056 positions) and of
    Granite-8B's (32/8 heads of 128); SM's K6 lse entry on a rank's block
    of Zamba2-7B's long_500k cache (32,768 of 65,536 positions, 32/32
    heads of 112, rows with 0, 1 and all positions live); TS's K4 and K5
    at MiniCPM-2B's rank 1 (4 x 2048 queries at offset 2048 over 4,096
    keys, 36 heads of 64)."""
    if tag == "SQ":
        half = SQ_MAX_LEN // 2
        return (k5_offset_records("SQ", SQ_BATCH, SQ_PROMPT // 2, SQ_PROMPT,
                                  36, 36, 64, SQ_PROMPT // 2, dev)[:1]
                + [k6_lse_record("SQ", SQ_BATCH, half, 36, 36, 64, dev, 940),
                   k6_lse_record("SQ", SQ_BATCH, half, 32, 8, 128, dev,
                                 950)])
    if tag == "SM":
        return [k6_lse_record("SM", 3, SM_ZAMBA["max_len"] // 2, 32, 32,
                              112, dev, 960)]
    return k5_offset_records("TS", TS_BATCH, TS_SEQ - TS_Q_OFFSET, TS_SEQ,
                             36, 36, 64, TS_Q_OFFSET, dev)


def split_attention_records(tag: str, dev) -> list:
    """K4, K5 and K6 at split path ``tag``'s local-head shapes, held and
    timed as :func:`attn_shape_records` and :func:`k6_shape_record` hold
    them, with each kernel's device time: ST's prefill (8 x 512, 16/4
    heads of 128: half of granite-8b's 32/8) and decode step (a
    1,024-position cache, 543 live); TT's tensor-parallel microbatch (1 x
    4096, 16/4 heads) and ZeRO-3's rank batch (2 x 4096, 32/8 heads)."""
    if tag == "ST":
        return attn_shape_records("ST", {"prefill": (
            ST_BATCH, ST_PROMPT, ST_PROMPT, 16, 4, 128, True)}, dev, False,
            device=True) + [k6_shape_record(
                "ST", ST_BATCH, ST_MAX_LEN, 16, 4, 128,
                ST_PROMPT + ST_STEPS - 1, dev, 520, device=True)]
    return attn_shape_records("TT", {
        "tp": (1, TT_SEQ, TT_SEQ, 16, 4, 128, True),
        "zero3": (TT_BATCH // 2, TT_SEQ, TT_SEQ, 32, 8, 128, True)},
        dev, True, device=True)


@contextlib.contextmanager
def cpu_workers():
    """Paths E's, U's and C's CPU runs, started in worker processes
    (``start_cpu_jobs``) that run while the card runs the paths before
    them; yields their futures.  On a failure the workers are stopped, not
    waited for."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    pool = ProcessPoolExecutor(CPU_WORKERS,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        yield start_cpu_jobs(pool)
    except BaseException:
        for proc in list((pool._processes or {}).values()):
            proc.terminate()
        pool.shutdown(wait=False, cancel_futures=True)
        raise
    pool.shutdown(wait=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sim.sweep import run_sweep_batched, scenario_families

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    torch.cuda.init()
    # Float32 products in full float32 on the card (the plain versions'
    # comparisons assume it), stated rather than left to the defaults.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log(f"build: {build_all():.2f} s")
    t_paths = time.perf_counter()
    with cpu_workers() as jobs:
        # Path V's BalancePowerCap is the object plane's, with 200 trips;
        # the reference's datacenter_cell is one cell of 10,000 hosts.
        shapes = {"A": (32, 100, 10, True, 100),
                  "B": (16, 1000, 10, True, 100),
                  "V": (1, 1000, 10, False, 200),
                  "cell": (1, 10_000, 10, False, 100),
                  "D": (32, 100, 15, True, 100),
                  "W": (1, 100, 10, False, 200),
                  "R": (2, 100, 10, True, 100),
                  "G": (32, 100, 15, False, 100),
                  "X": (32, 100, 15, False, 100),
                  "Q": (1, 100, 10, False, 200),
                  "U": (12, 1024, 16, True, 100),
                  "C": (2, 16_384, 16, True, 100)}
        records = check_kernels(shapes, dev)
        records["V"][0]["datacenter_cell"] = records.pop("cell")[0]
        records["V"].append(check_k3(dev))
        k3_100 = check_k3(dev, m_path=100, tag="W")
        records["W"].append(k3_100)
        records["R"].append(dict(k3_100))
        records["Q"].append(check_k3(dev, m_path=100, tag="Q"))
        records["E"] = check_eval_kernels(jobs, dev)
        rows = check_row_shapes(dev)
        cpu_g = cpu_migration_run(RULES_GRID, ("cpc", "static"))
        cpu_x = cpu_migration_run(TIMED_GRID, ("cpc", "static"))
        cpu_q = cpu_migration_run(None, ("cpc", "static"), engine="vector")
        for tag, cpu in (("G", cpu_g), ("X", cpu_x), ("Q", cpu_q)):
            records[tag] = (check_balancer_k1(tag, cpu["seen"], dev)
                            + records[tag])
        for rec in records["A"] + records["V"][1:]:
            rec["row_shapes_max_abs_err"] = rows[
                {"waterfill_dense": "K1", "balance_caps": "K2",
                 "waterfill_segmented": "K3"}[rec["name"].split()[0]]]

        policies = ("cpc", "static")
        specs_a = scenario_families(
            sizes=(100,), budgets_per_host_w=(230.0, 250.0),
            spikes=("flat", "burst", "step", "prime"),
            heterogeneous=(False, True), duration_s=600.0)
        gpu_a, launches_a, info_a = run_path("A", specs_a, policies)
        cpu_a = run_sweep_batched(specs_a, policies, device="cpu")
        compare("A", gpu_a, cpu_a, [(s.name, p) for s in specs_a
                                    for p in policies])

        specs_b = scenario_families(
            sizes=(1000,), budgets_per_host_w=(250.0,),
            spikes=("flat", "burst", "step", "prime"),
            heterogeneous=(False, True), duration_s=1200.0)
        gpu_b, launches_b, info_b = run_path("B", specs_b, policies)
        held = [s for s in specs_b if s.spike == "burst" and s.heterogeneous]
        cpu_b = run_sweep_batched(held, policies, device="cpu")
        compare("B", gpu_b, cpu_b,
                [(s.name, p) for s in held for p in policies])

        launches_v, info_v = run_vector_path(policies)

        gpu_d, launches_d, info_d = run_churn_path(policies)
        launches_w, info_w = run_churn_vector_path(policies, gpu_d)
        launches_rb, launches_rv, info_r = run_tree_path(policies)
        launches_r = {k: launches_rb[k] + launches_rv[k] for k in launches_rb}

        gpu_g, launches_g, info_g = run_migration_path(
            "G", cpu_g, policies, ("cap_changes", "vmotions"))
        gpu_x, launches_x, info_x = run_migration_path(
            "X", cpu_x, policies, ("cap_changes", "vmotions", "power_ons"))
        launches_q, info_q = run_migration_vector_path(
            policies, (gpu_g, gpu_x), cpu_q)

        launches_e, info_e = run_eval_path(jobs)
        launches_u, info_u = run_bucket_path(jobs["U",])
        launches_c, info_c = run_datacenter_path(jobs["C",])
        info_svc = run_service_phase(smi)
        log(f"the kernel checks and paths A-C, E, U and the service: "
            f"{time.perf_counter() - t_paths:.1f} s")

        t_models = time.perf_counter()
        records["S"] = [check_k4(dev), check_k6(dev)]
        launches_s, info_s = run_serving_path(dev)
        torch.cuda.empty_cache()
        info_s["float32_4_layers"] = run_f32_depth_check(dev)
        torch.cuda.empty_cache()

        records["T"] = check_k5(dev) + check_k5_wide(dev)
        torch.cuda.empty_cache()
        launches_t, info_t = run_training_path(dev)
        torch.cuda.empty_cache()
        info_t["float32_4_layers"] = run_train_f32_check(dev)
        torch.cuda.empty_cache()

        records["M"] = [check_k7(dev)] + check_m_attention(dev)
        launches_m, info_m = run_moe_serving_path(dev)
        torch.cuda.empty_cache()
        info_m["deepseek_float32_4_layers"] = run_moe_f32_check(dev)
        torch.cuda.empty_cache()

        k8 = check_k8(dev)
        records["P"] = [k8["P"]]
        d112, records["T"][1]["d112"] = check_d112(dev)
        records["H"] = [k8["H"]] + d112
        torch.cuda.empty_cache()
        launches_p, info_p = run_ssm_serving_path("P", dev)
        torch.cuda.empty_cache()
        launches_h, info_h = run_ssm_serving_path("H", dev)
        torch.cuda.empty_cache()
        info_p["float32_4_layers"] = run_ssm_f32_check("mamba2_2p7b", 4, dev)
        torch.cuda.empty_cache()
        info_h["float32_7_layers"] = run_ssm_f32_check("zamba2_7b", 7, dev)
        torch.cuda.empty_cache()

        records["TM"] = [check_k7_bwd(dev)] + check_train_attention("TM",
                                                                    dev)
        k8b = check_k8b(dev)
        records["TP"] = k8b["TP"]
        records["TH"] = k8b["TH"] + check_train_attention("TH", dev)
        torch.cuda.empty_cache()
        launches_tm, info_tm = run_family_training_path("TM", dev)
        torch.cuda.empty_cache()
        info_tm["float32_4_layers"] = run_moe_train_f32_check(dev)
        torch.cuda.empty_cache()
        launches_tp, info_tp = run_family_training_path("TP", dev)
        torch.cuda.empty_cache()
        launches_th, info_th = run_family_training_path("TH", dev)
        torch.cuda.empty_cache()
        log(f"paths S, T, M, P, H, TM, TP and TH and their kernel checks: "
            f"{time.perf_counter() - t_models:.1f} s")

        t_new = time.perf_counter()
        fresh = check_fresh_threads(dev)
        new = check_frontend_attention(dev)
        for tag in ("I", "Y", "TI", "TY"):
            records[tag] = new[tag]
        torch.cuda.empty_cache()
        launches_y, info_y = run_encdec_serving_path(dev)
        info_y["float32_whole"] = run_frontend_f32_check(
            "whisper_tiny", None, Y_PROMPT, Y_STEPS, TEXT_CTX, dev)
        torch.cuda.empty_cache()
        launches_ty, info_ty = run_frontend_training_path("TY", dev)
        torch.cuda.empty_cache()
        launches_i, info_i = run_vlm_serving_path(dev)
        torch.cuda.empty_cache()
        info_i["float32_4_layers"] = run_frontend_f32_check(
            "internvl2_26b", 4, 512, 32, 1024, dev)
        info_i["fresh_thread_entry_points"] = fresh
        torch.cuda.empty_cache()
        launches_ti, info_ti = run_frontend_training_path("TI", dev)
        torch.cuda.empty_cache()
        log(f"the fresh-thread launches, paths I, Y, TI and TY and their "
            f"kernel checks: {time.perf_counter() - t_new:.1f} s")

        t_mesh = time.perf_counter()
        records["SC"] = mesh_path_records("SC", dev)
        launches_sc, info_sc = run_sharded_sweep_path()
        records["ME"] = mesh_path_records("ME", dev)
        launches_me, info_me = run_expert_parallel_path()
        records["TE"] = mesh_path_records("TE", dev)
        launches_te, info_te = run_elastic_path()
        t_split = time.perf_counter()
        records["ST"] = mesh_path_records("ST", dev)
        launches_st, info_st = run_split_serving_path()
        records["TT"] = mesh_path_records("TT", dev)
        launches_tt, info_tt = run_split_training_path("TT")
        log(f"paths ST and TT and their kernel checks: "
            f"{time.perf_counter() - t_split:.1f} s")
        t_2c = time.perf_counter()
        records["SQ"] = mesh_path_records("SQ", dev)
        records["SM"] = mesh_path_records("SM", dev)
        launches_sq, launches_sm, info_sqm = run_part2c_serving_paths()
        records["TS"] = mesh_path_records("TS", dev)
        launches_ts, info_ts = run_split_training_path("TS")
        log(f"paths SQ, SM and TS and their kernel checks: "
            f"{time.perf_counter() - t_2c:.1f} s on {smi}")
        log(f"paths SC, ME, TE, ST, TT, SQ, SM and TS and their kernel "
            f"checks: "
            f"{time.perf_counter() - t_mesh:.1f} s on {smi} (the ranks "
            f"share one card, and gloo moves their tensors through host "
            f"memory: the "
            f"collectives' times are not an interconnect's)")

        info_dr = report_dryrun(jobs["DR",].result())
        info_roofline = report_roofline(
            jobs["roofline",].result(),
            {"S": info_s, "M": info_m, "P": info_p, "H": info_h,
             "I": info_i, "Y": info_y, "T": info_t, "TM": info_tm,
             "TP": info_tp, "TH": info_th, "TI": info_ti, "TY": info_ty},
            smi)

        kernels_out = []
        for tag, launches in (("A", launches_a), ("B", launches_b),
                              ("V", launches_v), ("D", launches_d),
                              ("W", launches_w), ("R", launches_r),
                              ("G", launches_g), ("X", launches_x),
                              ("Q", launches_q), ("E", launches_e),
                              ("U", launches_u), ("C", launches_c),
                              ("S", launches_s),
                              ("T", launches_t), ("M", launches_m),
                              ("P", launches_p), ("H", launches_h),
                              ("TM", launches_tm), ("TP", launches_tp),
                              ("TH", launches_th), ("I", launches_i),
                              ("Y", launches_y), ("TI", launches_ti),
                              ("TY", launches_ty), ("SC", launches_sc),
                              ("ME", launches_me), ("TE", launches_te),
                              ("ST", launches_st), ("TT", launches_tt),
                              ("SQ", launches_sq), ("SM", launches_sm),
                              ("TS", launches_ts)):
            for rec in records[tag]:
                name = rec["name"].split()[0]
                kernels_out.append(dict(rec, launches=launches[name],
                                        path=tag))

    log(json.dumps({"paths": {"A": info_a, "B": info_b, "V": info_v,
                              "D": info_d, "W": info_w, "R": info_r,
                              "G": info_g, "X": info_x, "Q": info_q,
                              "E": info_e, "U": info_u, "C": info_c,
                              "service": info_svc, "S": info_s,
                              "T": info_t, "M": info_m, "P": info_p,
                              "H": info_h, "TM": info_tm, "TP": info_tp,
                              "TH": info_th, "I": info_i, "Y": info_y,
                              "TI": info_ti, "TY": info_ty, "SC": info_sc,
                              "ME": info_me, "TE": info_te,
                              "ST": info_st, "TT": info_tt,
                              "SQ+SM": info_sqm, "TS": info_ts,
                              "DR": info_dr, "roofline": info_roofline}},
                    default=str))
    log(json.dumps({"kernels": kernels_out}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
