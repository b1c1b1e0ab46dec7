#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (nonzero exit, no result line):

1. Environment: torch, CUDA, nvcc, triton, the card's name and power
   limit. TF32 is switched off for matmuls and cuDNN.
2. Build: the port's CUDA kernels from ``euler_tpu_torch/csrc/`` and,
   beside them, the graph engine from ``euler_tpu_torch/graph/_native/``.
3. Kernels vs plain, on the full synthetic PPI graph (56,944 nodes), for
   the chained two-hop draw ``sample_fanout2`` (B1) and the single-hop
   draw ``sample_neighbor`` (B2):
   (a) B1 at the ppi shape (512 roots, [10, 10]) equals
   ``sample_fanout2_reference`` exactly, with injected uniforms and with
   Philox, on roots that include a negative id, an id past the slab, the
   default row and zero-weight rows; (b) Philox hop-1 pick frequencies of
   four fixed rows over 10^5 draws each match the ``cum`` probabilities
   within a total variation distance of 0.03, and every pick is a real
   neighbor of its row or the default; (c) B1, its plain version and a
   ``torch.multinomial`` yardstick, timed with CUDA events;
   (d) B2 equals ``sample_neighbor_reference`` exactly at [512, 1] (the
   unsupervised positives), at [5,120, 10] (a hop-2 shape), at [512, 10]
   (ScalableSage's draw) and at [512, 5] (GAT's), with injected and
   Philox uniforms, on the same kinds of odd roots;
   (e) B1 equals two chained B2 launches (hop 0 on the roots, hop 1 on the
   hop-1 picks) bit for bit, so the shared draw routine is shared;
   (f) B2's pick frequencies as in (b); (g) B2, its plain version and a
   ``torch.multinomial`` yardstick at those four shapes; (h) B1 equals
   its plain version with Philox uniforms at 2,560 roots (the
   unsupervised negatives' fanout), and is timed there as in (c); (i) both kernels
   equal their plain versions with Philox uniforms on synthetic slabs
   of width 128 and 1,024 (rows of random degree up to the width), each
   timed warm; (j) on the synthetic Reddit graph at ``bench.py``'s shape
   (232,965 nodes, W = 60), B1 at the reddit shape (1,000 roots, [4, 4])
   equals its plain version with injected and Philox uniforms on the same
   kinds of odd roots, and is timed as in (c); (k) the alias draw (plain
   PyTorch, no kernel) on CUDA tensors equals the same draw on CPU
   tensors bit for bit, single hop and a [4, 4] fanout with Philox
   uniforms, on a 9,000-node power-law graph with hub rows, and launches
   no kernel; (l) ``random_walk`` at node2vec's shape (15,360 walkers,
   walk_len 5) over the weighted ppi slab on CUDA tensors equals the same
   walk on CPU tensors bit for bit, on the same kinds of odd roots, with
   exactly five B2 launches, and B2 is timed at [15,360, 1] as in (g);
   (m) the biased walks, plain PyTorch, no kernel: the 2-step joint of
   ``biased_random_walk`` (10^5 walkers from one root of the sorted
   slab) matches the analytic node2vec joint within a TVD of 0.03 for
   (p, q) = (4, 0.25) and (0.25, 4); at 15,360 walkers its CUDA and CPU
   picks are compared (float32 cumsums may round apart: the differing
   picks are counted, every pick must be a legal transition); and
   ``alias_biased_random_walk`` over (k)'s graph's sorted alias tables
   equals the same walk on CPU tensors bit for bit; (n) on a
   heterogeneous variant of the ppi graph (each edge typed 0 or 1 by a
   seeded coin, four node types, uint64 slot 0 the node's own id), B1
   over two distinct slabs of different widths (hop 1 over et0 or et1,
   hop 2 over et0_1, as the lasgnn path launches it) equals its plain
   version at [512, 10, 10] and [1,024, 10, 10], and B2 over et0 at
   lshne's [512, 1] equals its own, with injected and Philox uniforms, on
   the same kinds of odd roots, each timed as in (c); (o) ``sample_node_with_src`` (plain PyTorch, no kernel) on CUDA
   tensors equals the same draw on CPU tensors bit for bit at the lshne
   shape (6,144 sources x 5), every pick of its source's type and sources
   of unknown type drawing type 0, and is timed; (p) the wide path, on
   synthetic slabs of 4,096 rows at W 2,048, 8,192 and 16,384 (random
   degrees up to W, a quarter of the rows full): B1 at [512, 10, 10] and
   [1,000, 4, 4] and B2 at [512, 1] and [512, 10] equal their plain
   versions with injected and Philox uniforms on the same kinds of odd
   roots, so does B1 at [512, 10, 10] over a slab of width 1,024 then
   the wide one and the reverse (a metapath's two slabs), B1 equals two
   chained B2 launches, each shape is timed as in (c)
   with its bound counted over each row's degree, and at W 16,384 the
   slot frequencies of 10^6 B2 draws from one full-width row pass a
   chi-square test; (q) at W 2,048 the sharded routes at a rank's [256,
   10, 10] and [256, 1] equal their plain versions at the rank's folded
   seed words, one launch each. Each kernel time is
   taken warm (``ms``), with the L2 cache flushed by a 128 MiB write
   before each launch (``ms_cold``), and beside ``floor_ms``, an empty
   kernel at the kernel's grid under the same timer, and ``bound_ms``,
   the least time the card could take for the draws of this run
   (``draw_bound``).
4. Train, each path with the launch counts set to 0 just before it and
   read just after: a small model agrees between CPU (plain draws) and
   CUDA (kernels) step for step; then ``SupervisedGraphSage`` at full ppi
   width (dim 256, batch 512, fanouts [10, 10], Adam 0.01) trains through
   ``train.make_scan_train`` with B1 launched once per step. The same for
   the unsupervised ``GraphSage`` (the JAX package's ``run_loop --model
   graphsage`` defaults: dim 256, fanouts [10, 10], batch 512, 5
   negatives, concat, sigmoid cross-entropy, Adam 0.01): B2 once per step
   (the positives) and B1 three times (the fanouts of roots, positives
   and negatives). Then the GCN family, each after a small CPU/CUDA
   agreement, none launching B1 or B2 (gathers, a sort, cumsums and
   segment sums, as in the JAX package): ``SupervisedGCN`` at ``run_loop
   --model gcn --device_sampling``'s defaults (dim 256, metapath [[0],
   [0]], caps [5,120, 51,200], batch 512, sigmoid loss, Adam 0.01, roots
   drawn on the card each step) with the mean (gcn), gcn (gcn_gcnagg) and
   attention (gcn_attention, 4 heads of 64) aggregators, after one
   batch's expansion is printed hop by hop against its caps and
   ``multi_hop_neighbor`` is timed alone; and ``ScalableGCN`` at
   ``--model scalable_gcn``'s (2 layers, slab rows of 10, store lr 0.001,
   store init 0.05) through ``train.make_scan_train``, printing its
   stores' bytes. Each prints the aggregated (real, masked-in) edges a
   step and their rate. Then the single-hop models through
   ``train.make_scan_train``, each after a small CPU/CUDA agreement, B2
   once a step and B1 never: ``ScalableSage`` at ``run_loop --model
   scalable_sage --device_sampling``'s defaults (fanout 10, 2 layers,
   dim 256, mean, concat, store lr 0.001, store init 0.05: scalable_sage,
   B2 at [512, 10]), and ``GAT`` at ``--model gat``'s (hidden 256, 5
   neighbors, 121 classes: gat with one head, gat_heads4 with four, the
   hidden widths of the GAT paper's PPI model: B2 at [512, 5]); after
   training, each runs ``train.evaluate`` over 10 batches of 512 roots
   that were never a training root and prints f1 and loss. Then the
   sparse-feature models on the heterogeneous variant, each after a small
   CPU/CUDA agreement: ``LsHNE`` at ``run_loop --model lshne
   --device_sampling``'s defaults (one view of two [[0], [0], [0]]
   metapaths, dim 128, hidden 256, slot 0 embedded at 16, windows 1/1, 5
   typed negatives over 20 types, batch 512) through
   ``train.make_scan_train``: lshne, B2 six times a step at [512, 1], B1
   never, peak allocated memory under 2 GB; and ``LasGNN`` (the JAX
   package's target/context metapaths at fanouts [10, 10], dim 256, mean,
   batch 512) on inputs drawn on the card (half the rows a target with
   two of its neighbors, label 1; half with two sampled nodes, label 0)
   through ``make_train_step``: lasgnn, B1 three times a step, B2 never;
   each then runs ``train.evaluate`` over 10 batches and prints mrr or
   auc. Then ``bench.py``'s reddit recipe (batch 1,000,
   fanouts [4, 4], dim 64, Adam 0.03, 602 features, 41 one-hot labels,
   sigmoid loss): reddit (B1 once per step), reddit_bf16 (the same with a
   bfloat16 feature table) and reddit_heavytail (the power-law graph at
   114.6M edges over alias tables: no kernel launch), each printing its
   build times, its tables' bytes on the card and the peak of allocated
   device memory; then reddit_heavytail_slab: the same recipe on the
   heavy-tail graph over its slab at max_degree 4,096 (7.63 GB on the
   card, built by the same child process as the graph), after a CPU/CUDA
   agreement on a power-law graph whose widest row passes 1,024: B1 once
   a step on the wide path. Then the walk models (the JAX package's ``run_loop
   --model node2vec --device_sampling`` and ``--model line`` defaults:
   dim 256, id embeddings, combiner add, 5 negatives, sigmoid
   cross-entropy, Adam 0.01), Node2Vec and LINE each after a small
   CPU/CUDA agreement: node2vec (walk_len 5, windows 5/5, 15,360 roots a
   step: B2 five times a step at [15,360, 1]), node2vec_biased (p 4, q
   0.25 over the sorted slab: no kernel), line (order 1, 512 roots: B2
   once a step at [512, 1]) and node2vec_heavytail (node2vec_biased's
   recipe on reddit_heavytail's graph over sorted alias tables: the exact
   rejection walk, no kernel), each printing walk edges and pairs a step
   with their rates and the launches a step.
5. Engine and run_loop, on the full synthetic ppi graph: (a) the
   engine's build time (phase 2); (b) ``datasets.build_ppi`` writes it
   as ``.dat`` files (seconds, bytes); (c) ``graph.Graph(directory=...)``
   loads them (seconds, nodes, edges); (d) the slab, root sampler,
   feature and label tables built from the engine equal, on the card, bit
   for bit, those built from ``MemoryGraph`` over the same seed's arrays;
   (e) ``run_loop.main`` trains ``--model graphsage_supervised
   --device_sampling 1`` at the ppi widths for one epoch (``--max_id
   56943``: 111 steps, B1 exactly once a step), the loss finite and
   falling, the checkpoint at step 111, then ``--mode evaluate`` writes
   eval.json with f1 in [0, 1] and ``--mode save_embedding`` writes
   embedding.npy [56,944, 256] equal to ``train.save_embedding`` of the
   restored state; (f) the same with host sampling (the engine's
   ``sample_fanout`` through ``prefetch``, no kernel launched in any of
   the three modes; its export, drawn on the engine's OpenMP threads,
   is held to a fresh export of the same state by row cosine), then one
   ``torch.profiler`` window of 10 host-sampled ``train.train`` steps for
   the device busy share; (g) the device run's checkpoint restored into a
   fresh model gives the trained state's forward bit for bit. Each run
   prints its step ms (median of steps 11-111), edges/s, the batch build
   ms in a prefetch worker, the input stall and the steps that waited
   on prefetch, and the peak of allocated device memory; (h) ``python -m
   euler_tpu_torch --device_sampling 1`` with ``--max_degree`` unset, at
   ppi's widths for 8 epochs (312 steps), on a power-law graph of 20,000
   nodes and 2M edges (widest row 5,000) written as ``.dat`` files:
   cli_wide_supervised (``--model graphsage_supervised``, B1 once a step)
   and cli_wide_graphsage (``--model graphsage``, B2 for the positives and
   B1 thrice a step), the launches read from the processes' logs.
6. serve_ppi: phase 5 (f)'s host-sampled checkpoint served at ppi's
   widths by ``serve.run_serve`` (``build_server``, max_batch 64,
   max_wait_us 2000, an ``EmbedFrontend``), the forward one CUDA graph
   of one fixed bucket: 16 client threads send 200 requests of 1-16 ids
   (half from a hot set of 256 ids, half from the whole graph, a quarter
   with a duplicate); every served row equals ``embed_direct`` on the
   card bit for bit; one bucket equals the CPU's eager forward of the
   same blocks (rtol 1e-4, atol 1e-5); exactly one capture, no
   re-capture and no B1 or B2 launch; it prints the request latency at
   the client (p50, p99) and the SLO tracker's verdict, the serve
   phases' p50/p99, dispatches and mean unique ids a dispatch, the first
   (capturing) dispatch, a cold and a warm dispatch of 64 ids, the bytes
   up and down a dispatch, the peak of allocated device memory and the
   sample cache's host bytes. Then ``python -m euler_tpu_torch.serve``
   on the same checkpoint answers one embed over the wire, bit-equal to
   the in-process row, and drains to exit code 0 on SIGTERM.
7. The host-sampled model zoo (``run_loop --device_sampling 0``, the JAX
   CLI's default), on phase 5's ppi files, each path with the launch
   counts set to 0 just before it and read just after: B1 and B2 launch
   0 times on every one. First, gcn's and scalable_gcn's host expansion
   at the CLI's caps (batch * max(fanouts)**h: 5,120 at hop 1) raises,
   as the JAX package's host path does (512 ppi roots reach some 7,150
   unique neighbors). Then ``run_loop.main`` at the JAX CLI's defaults
   and ``RUN_LOOP_ARGS``' ppi widths, one epoch (111 steps), for gcn
   (mean) and scalable_gcn at fanouts 16,16 (caps [8,192, 131,072] and
   8,192), scalable_sage (fanout 10), gat (5 neighbors), gat with
   ``--device_features 1`` (host-sampled ids, features and labels read
   from the card's tables), line (order 1), node2vec (15,360 roots a
   step) and saved_embedding over phase 5 (f)'s ``embedding.npy``; each
   after a CPU/CUDA agreement on one host batch of 64 roots (three steps
   from the same init), then ``--mode evaluate`` and ``--mode
   save_embedding``: the loss finite, falling from the first ten steps
   to the last (but for line, whose fresh batches need not: phase 4),
   and lower on its first 10 batches replayed than at init; eval's
   metric in [0, 1]; the export bit-equal to the trained id table (walk
   models) or the frozen table (saved_embedding), else close by row
   cosine to a fresh export of ids 0-4,095. Then the heterogeneous
   variant of phase 3 (n) written as ``.dat`` files (``datasets.write_dat``,
   uint64 slot 0 read back), ``--model lshne`` over it the same way, and
   ``LasGNN`` through ``train.train`` over that ``Graph`` on host-drawn
   inputs shaped as phase 4's lasgnn, for 100 steps, then
   ``train.evaluate`` over 10 fresh batches. Each run prints its step ms
   (median of steps 11-111), edges/s or pairs/s, the batch build ms in a
   prefetch worker, the input stall and the steps that waited, a full
   batch's bytes and upload ms, the loss, the metric, the peak of
   allocated device memory and a profiler window's device ms and busy
   share, beside the card's name and power limit.
8. Remote and shared graphs over phase 5's ppi files: (a) two shard
   processes, ``python -m euler_tpu_torch.graph.service --shard_num 2``,
   on a flat-file registry, each shard's load time printed; (b) 1,000
   seeded ids read through ``Graph(mode="remote")`` equal the local
   engine's reads (counts, types, full neighbours, dense features,
   top-k); (c) ``run_loop --graph_mode remote --registry R --model
   graphsage_supervised`` trains an epoch on the card through the
   ``--sampler_depth`` ring of async fanouts, evaluates and exports, as
   phase 5's paths (step ms, input stall, ids on the wire a step, the
   client's feature and neighbour cache hits, peak memory, f1), then a
   ``torch.profiler`` window of 10 remote-sampled ``train.train``
   steps; (d) the rolling-restart drill of ``tests/
   test_rolling_restart.py`` (same schedule, client settings and loss
   tolerance): (c)'s training again while each shard in turn is
   SIGTERM-drained and restarted on a new port, with zero failed calls;
   (e) the same command as ``--graph_mode shared --registry
   tcp://127.0.0.1:<free port>`` in this process; (f) (c)'s checkpoint
   served over the remote graph to 16 client threads (200 requests of
   1-16 ids), p50 and p99 against the 100 ms SLO, rows bit-equal to
   ``embed_direct``; then a delta on shard 0 moves ``cache_gen``, the
   stale blocks are evicted, and rows served afterwards are bit-equal to
   ``embed_direct`` on the new graph. B1 and B2 launch 0 times on every
   phase-8 path; the shards drain to exit code 0 on SIGTERM.
9. Training's observability plane, on phase 5's ppi files: (a)
   ``run_loop --device_sampling 1`` for an epoch with every plane on
   (``--telemetry 1 --devprof 1 --blackbox 1 --metrics_every 10
   --metrics_file --trace_file --profile_dir --postmortem_dir``): B1 once
   a step; each step phase (input_stall, sample, h2d, device, host,
   step) recorded once a step, with p50 and p99 printed; a metrics line
   every 10 steps; the merged trace valid, one B1 kernel event in each
   of the 10 profiled steps (``torch.profiler`` over steps 10-19), each
   inside its step's ``device`` phase give or take 1 ms, and the
   profiled steps' device ms, device events, kernels and busy share a
   step; the memory gauge equal to ``torch.cuda.memory_allocated``
   at a sample; no postmortem; (b) the step fence's cost: the median host
   step of steps 11-111 with ``--telemetry 1`` (each step fenced on its
   loss) and ``0``, in the order 1, 0, 0, 1, one log window a run;
   (c) run_loop_host's step split into its phases; (f) the console's
   ``stats phases``, ``stats devprof`` and ``nb`` on the ppi files;
   (d) serve_ppi's ``stats()["devprof"]`` over phase 5's host
   checkpoint: one capture (one compile), no recompile, and a
   ``strict_bucket`` server that raises ``devprof.RecompileError`` on a
   changed layout and keeps its one capture; (e) a child process that
   imports only the port, holds 64 MiB on the card, arms
   ``--postmortem_dir`` and dies by SIGSEGV leaves one postmortem that
   ``postmortem_read`` parses, its resource ring's device memory the
   child's ``memory_allocated``.
10. Serving the zoo: phase 7's checkpoints (``work/z_<name>``) and
    LasGNN's (phase 7 saves its trained state) served at their full
    widths by ``serve.run_serve`` (max_batch 64, max_wait_us 2000), each
    path with the launch counts set to 0 just before it and read just
    after: serve_gcn and serve_scalable_gcn (exact-size blocks joined
    with offsets into buckets at the model's caps, a dispatch past them
    split into more forwards), serve_scalable_sage, serve_gat,
    serve_line, serve_node2vec, serve_lshne, serve_saved_embedding and
    serve_lasgnn (leaf by leaf). On each, 4 client threads send 40
    requests each of 1-16 ids (``serve_traffic``'s shape); every served
    row equals ``embed_direct`` on the card bit for bit; one bucket
    equals the CPU's eager forward of the same blocks (rtol 1e-4, atol
    1e-5); exactly one capture, no re-capture, no B1 or B2 launch; it
    prints the client's p50 and p99, the first (capturing), a cold and a
    warm dispatch of 64 ids, the bucket's bytes and the mean bytes up a
    forward, the forwards a dispatch, and the peak of allocated device
    memory. Then ``python -m euler_tpu_torch.serve --model gcn`` answers
    one embed over the wire, bit-equal to the in-process row, and drains
    to exit code 0 on SIGTERM.
11. Multi-device training (``parallel.mesh``), on the full ppi graph:
    (a) mesh_nccl1: one rank over NCCL, ppi drawn on the card for 20
    steps through ``train.train(mesh=)``, its losses bit-equal to the
    unsharded run's at the same seed (an all-reduce over one rank is the
    identity); (b) mesh_dp2: two spawned ranks sharing the card over
    gloo, data axis 2, ppi at batch 512 (256 a rank) for 50 steps, B1
    through ``sample_fanout2_sharded`` once a step a rank, the ranks'
    parameter digests equal after the steps, each rank's B1 at its folded
    seed words equal to the plain version at those words, the gradient
    all-reduce timed; then the unsupervised GraphSage for 10 steps (B1
    three and B2 once a step a rank, both sharded); (c) mesh_mp2: the
    same two ranks at ``model_parallel`` 2, each holding half of the
    padded feature and label rows, the first-step loss on the parent's
    host batch within rtol 1e-5 of (b)'s on the same batch, then 10 steps;
    (d) mesh_cli2: two processes of ``python -m euler_tpu_torch
    --graph_mode shared --coordinator_addr ... --num_processes 2`` over
    phase 5's ppi files, each serving its shard, train, evaluate and
    export; the two exports' digests equal and the loss falls. Then both
    sharded routes at a rank's shapes against their plain versions,
    timed.
12. Staged data, prepared data, the other optimizers and the model
    options, on phase 5's ppi files, each path with the launch counts
    set to 0 just before it and read just after: (a) the files put into
    fsspec's in-process ``memory://`` store (its version printed; no
    fsspec fails the phase), then loaded streamed (``Graph(stream=
    True)``), staged into a cache directory (``cache_dir=``) and locally:
    equal node and edge counts and equal digests of the device tables
    built from each; then ``run_loop --data_dir memory://... --stream 1
    --device_sampling 1`` for an epoch (staged_ppi_stream: B1 once a
    step); (b) ``sgd``, ``momentum`` and ``adagrad``, each after a
    CPU/CUDA agreement on a 2,000-node graph, through ``run_loop
    --optimizer`` for an epoch (run_loop_sgd, run_loop_momentum,
    run_loop_adagrad: losses finite, B1 once a step); (c) GraphSAGE-format
    PPI files from the seed at PPI's size (56,944 nodes, 50 features, 121
    labels, mean degree 15), ``python -m euler_tpu_torch.datasets
    prepare_ppi`` in a subprocess (its seconds printed), then an epoch
    on the result (prepared_ppi: B1 once a step); (d)
    ``GraphSage(shared_negs=True)`` at ``run_loop --model graphsage``'s
    defaults (graphsage_shared_negs: B2 once and B1 three times a step)
    and ``SupervisedGraphSage(use_id=True)`` (ppi_use_id: B1 once a
    step), each after a CPU/CUDA agreement, through
    ``train.make_scan_train``; a bfloat16 feature table through
    ``EULER_TPU_FEATURE_DTYPE`` equal, table and gathered rows, to the
    ``feature_dtype`` kwarg's.
13. Operations, each path a subprocess that must exit 0, its seconds
    and the card's name and power limit printed: the seven tools of
    ``euler_tpu_torch/scripts/`` as ``python -m
    euler_tpu_torch.scripts.<tool>``, in lanes run at once (beside
    mesh_serve_after below: the six self-checks, ``--smoke`` and
    ``--ab-smoke``, together while the phase's two shard processes load,
    then the tools over those shards and phase 9's artifacts together
    with both drills): ops_metrics_dump (``--smoke``,
    then ``--watch 1 --iterations 3`` over the phase's own two shard
    processes of phase 5's ppi files: both shards in every scrape),
    ops_trace_dump (``--smoke`` on the card, then phase 9's run trace
    merged with the live shards' spans), ops_postmortem (``--smoke``,
    then phase 9 (e)'s SIGSEGV dump merged with its run trace),
    ops_heat_dump (``--smoke``, ``--ab-smoke``), ops_devprof_dump
    (``--smoke``: supervised GraphSAGE steps at ppi's widths, one
    journaled recompile, B1 in the kernel table as many times as its
    counter rose over the capture; then phase 9's capture, B1 once in
    each of its 10 profiled steps), ops_epoch_drill and ops_serve_drill
    at the JAX scripts' defaults on the card; then mesh_serve_after:
    ``python -m euler_tpu_torch --num_devices 2 --model_parallel 2
    --device_sampling 1 --serve_after 1`` over phase 5's ppi files (two
    gloo ranks sharing the card for an epoch, B1 once a step a rank),
    served by the launching process to 4 clients x 40 requests of 1-16
    ids, every row bit-equal to ``python -m euler_tpu_torch.serve
    --model_parallel 2``'s on the same checkpoint, both drained to exit
    code 0 by SIGTERM. B1's launches on ops_devprof_dump and on each
    rank of mesh_serve_after are read from their ``kernel launches``
    lines.
14. From install to a model that learns, in lanes of processes beside
    the gate, each path's seconds and the card's name and power limit
    printed: (a) the convergence gate (``euler_tpu_torch.convergence``,
    the ten cases of the JAX ``tests/test_convergence.py`` at its sizes,
    steps, seeds and thresholds, on the planted-community graph of 2,000
    nodes) on the card, each case with the launch counts set to 0 just
    before it and read just after: B1 once a training step on
    gate_graphsage_device_sampling and gate_scan_train, no draw kernel
    on the other eight; each F1, accuracy and MRR printed beside its
    floor, a miss raising (unsup_sage, whose loss is unbounded below
    and whose outcome is chaotic in both packages, runs from sixteen
    seeds, each run held to the JAX floors and the share of runs that
    clear them to the JAX package's share less two standard errors);
    (b) ``python -m euler_tpu_torch.scripts.
    ppi_dress_rehearsal`` at its defaults (56,944 nodes, 818,716 links,
    dim 256, batch 512, one epoch): exit 0, val micro-F1 above the
    all-positive predictor's plus 0.1; (c) the Reddit rehearsal at its
    defaults (232,965 nodes x 602, 41 classes, average degree 25, one
    epoch at batch 1,000), its replica written and prepared by a child
    process from the start of phase 3 on (``reddit_replica``), trained
    and evaluated in a process of its own: val accuracy above the
    majority class's plus 0.1; (d) the three Python examples through
    their ``main`` at their widths for 300 steps, the loss of the last
    window below the first's: ``sage`` on (b)'s prepared files,
    ``sage_reddit`` on (c)'s, and ``custom_sage_reddit``, which
    aggregates neighbours alone, on a planted-community graph of
    Reddit's shape (232,965 nodes, 602 features, 41 communities as
    labels), built by a second child from phase 3 on (``planted_reddit``;
    the replica's labels are a function of a node's own features, which
    that model never reads); and
    ``euler_tpu_torch/examples/dist_train.sh`` over two shards of phase
    5's ppi files for an epoch; (e) ``pip wheel --no-deps
    --no-build-isolation`` of the checkout, ``pip install --no-deps
    --target``, then the installed ``euler-tpu-torch`` from a directory
    outside the checkout with only the install on ``PYTHONPATH`` trains
    an epoch of phase 12's prepared ppi files drawn on the card (B1 once
    a step), its engine and kernels built under the install from its own
    sources. The processes' launch counts are read from their ``kernel
    launches`` lines.
15. The ``kernels`` line (the sharded routes beside the kernels, each
    with its launches by path; each kernel's wide-path shapes of phase 3
    (p) under ``wide_slabs``, each sharded route's call of phase 3 (q)
    under ``wide``); then the final ``ok`` line. Each phase
    prints its wall time.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import logging
import os
import re
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

PPI_BATCH = 512
PPI_FANOUTS = (10, 10)
PPI_DIM = 256
PPI_LR = 0.01
# bench.py's reddit recipe (bench.py:106-130, 608-625)
REDDIT_BATCH = 1000
REDDIT_FANOUTS = (4, 4)
REDDIT_DIM = 64
REDDIT_LR = 0.03
# phase 3 (k)'s power-law graph: hub_degree is max(2048, n // 64) = 2048
# and d_cap n // 4 = 2,250, so the largest rows are hubs
ALIAS_CHECK = dict(num_nodes=9000, num_edges=270_000, feature_dim=8,
                   label_dim=4)
SAGE_NEGS = 5
# run_loop --model node2vec's defaults (run_loop.py:91-102, 141-144,
# 570-584, 725): walk_len 5, windows 5 and 5 (30 pairs a root), and
# --batch_size 512 times those 30 pairs: 15,360 roots a step
N2V_WALK_LEN = 5
N2V_WINDOW = 5
N2V_ROOTS = PPI_BATCH * 30
# the JAX package's biased-walk settings (p, q), both sides of 1
BIASED_PQ = ((4.0, 0.25), (0.25, 4.0))
BIASED_WALKERS = 100_000
CHUNK_STEPS = 20
TIMED_CHUNKS = 4
TVD_BOUND = 0.03
# run_loop --model scalable_sage and --model gat (run_loop.py:139-183,
# 655-688): ScalableSage draws fanouts[0] = 10 neighbors a root, GAT
# nb_num = 5; gat_heads4 is --head_num 4, the GAT paper's hidden heads
SSAGE_FANOUT = PPI_FANOUTS[0]
GAT_NB = 5
GAT_HEADS4 = 4
EVAL_BATCHES = 10
# the sparse-feature cells' heterogeneous ppi variant: two edge types (a
# seeded coin an edge), four node types, uint64 slot 0 the node's own id
HET_NODE_TYPES = 4
# run_loop --model lshne --device_sampling's defaults (run_loop.py:689-700,
# 139-192): one view of two 3-step metapaths over edge type 0, windows
# 1/1, so pair_count(4, 1, 1) = 6 pairs a walk and 12 a root; 5 typed
# negatives over src_type_num 20 types
LSHNE_PATTERNS = [[[[0], [0], [0]], [[0], [0], [0]]]]
LSHNE_DIM = 128
LSHNE_NEGS = 5
LSHNE_TYPES = 20
LSHNE_PAIRS = PPI_BATCH * 12
# LasGNN's structure in the JAX package's tests (test_device_graph.py:
# 821-833) at run_loop's widths: the target over [0] then [0, 1], the
# context (two nodes a row) over that and over [1] then [0, 1]
LASGNN_METAPATHS = [[[[0], [0, 1]]], [[[0], [0, 1]], [[1], [0, 1]]]]
LASGNN_GROUP_SIZES = [1, 2]
# B1's root counts on the lasgnn path: the targets and the context
HET_B1_ROOTS = (PPI_BATCH, PPI_BATCH * 2)
# the single-hop draw's shapes: the unsupervised positives, a hop-2 shape
# of the ppi fanout (512 * 10 rows, 10 draws each), ScalableSage's draw
# and GAT's, each a hop-0 draw on the roots
B2_SHAPES = ((PPI_BATCH, 1), (PPI_BATCH * PPI_FANOUTS[0], PPI_FANOUTS[1]),
             (PPI_BATCH, SSAGE_FANOUT), (PPI_BATCH, GAT_NB))
# the chained draw's root counts: the ppi batch, and the unsupervised
# negatives' fanout (512 * 5)
B1_ROOTS = (PPI_BATCH, PPI_BATCH * SAGE_NEGS)
# slab widths past the main paths' W = 32 held exact in phase 3 (i): a
# staged draw of 4 slots a lane, and the widest, 32 slots a lane (64 KB
# of shared memory a block, past the default 48 KB)
WIDE_WIDTHS = (128, 1024)
# the wide path (phase 3 (p)-(q)): synthetic slabs past the register
# layout's 1,024 slots, at the main paths' counts (B1 at ppi's fanouts
# at both of B1_ROOTS' root counts, as phase 5 (h)'s graphsage run sends
# [2,560, 10, 10] to the wide path, and at reddit's; B2 at the positives'
# and ScalableSage's), each shape
# timed over WIDE_TIMED_RUNS; WIDE_FREQ_DRAWS draws of one full-width row
# held to its probabilities by chi-square (the mean plus CHI2_SIGMAS
# standard deviations)
WIDE_DRAW_WIDTHS = (2048, 8192, 16384)
WIDE_DRAW_ROWS = 4096
WIDE_B1_SHAPES = ((PPI_BATCH, *PPI_FANOUTS), (PPI_BATCH * SAGE_NEGS,
                                              *PPI_FANOUTS),
                  (REDDIT_BATCH, *REDDIT_FANOUTS))
WIDE_B2_SHAPES = ((PPI_BATCH, 1), (PPI_BATCH, SSAGE_FANOUT))
WIDE_TIMED_RUNS = 20
# the narrow slab of the mixed-width fanouts: the widest the register
# layout takes
WIDE_MIXED_NARROW = 1024
WIDE_FREQ_DRAWS = 1_000_000
CHI2_SIGMAS = 6
# warps a block of the draw kernels (csrc/draw.cuh kWarpsPerBlock): the
# wide path's block a row is this many warps of the empty kernel's grid
KERNEL_WARPS = 8
# reddit_heavytail_slab: the heavy-tail graph's slab at this max_degree
# (7.63 GB, 50.1% of its edges kept; 1,024 keeps 32.9%)
HEAVY_SLAB_DEGREE = 4096
# (nodes, edges) of build_powerlaw graphs whose widest rows pass 1,024:
# the agreement graph of reddit_heavytail_slab (widest row 1,226) and the
# CLI's files of phase 5 (h) (20,000 nodes, widest row 5,000)
WIDE_SMALL_GRAPH = (5000, 200_000)
WIDE_CLI_GRAPH = (20_000, 2_000_000)
WIDE_CLI_EPOCHS = 8
# a write of this many bytes evicts the slab from the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
# the host-sampled export against a second export of the same restored
# state over fresh draws: the least margin of their rows' median cosine
# over that of unrelated rows (0.91 against 0.54 on a 12,000-node CPU
# rehearsal)
EXPORT_COSINE_MARGIN = 0.2
# run_loop's flags of the ppi path (bench.py's ppi widths, as phase 4's
# ppi): --max_id, --data_dir and --model_dir are added per run
RUN_LOOP_ARGS = [
    "--model", "graphsage_supervised", "--feature_idx", "1",
    "--feature_dim", "50", "--label_idx", "0", "--label_dim", "121",
    "--train_edge_type", "0", "--all_edge_type", "0",
    "--fanouts", ",".join(map(str, PPI_FANOUTS)), "--dim", str(PPI_DIM),
    "--batch_size", str(PPI_BATCH), "--learning_rate", str(PPI_LR),
    "--num_epochs", "1", "--log_steps", "1",
]
# phase 7 (the host-sampled model zoo): run_loop's other models at their
# defaults over phase 5's ppi files, sampled on the host. The GCN
# family's host expansion raises past its caps, as the JAX package's host
# path does, and at the CLI's cap rule (batch * max(fanouts)**h) 512 ppi
# roots reach some 7,150 unique hop-1 neighbors (7,454 at most over 400
# CPU draws) against 5,120: gcn and scalable_gcn run at fanouts 16,16
# (caps 8,192 and 131,072, 8,192 edges a hop-1 batch against 7,997 at
# most), after the phase shows the defaults raise
ZOO_GCN_FANOUTS = (16, 16)
ZOO_AGREE_ROOTS = 64
ZOO_REPLAY_STEPS = 10
ZOO_LASGNN_STEPS = 100
# the serving phase (serve_ppi): run_loop_host's checkpoint served at the
# JAX package's serve defaults (max_batch 64, max_wait_us 2000) to
# SERVE_CLIENTS threads sending SERVE_REQUESTS requests of 1 to
# SERVE_MAX_IDS ids, half drawn from a hot set of SERVE_HOT ids and half
# from the whole graph, a quarter with a duplicated id
SERVE_MAX_BATCH = 64
SERVE_WAIT_US = 2000
SERVE_CLIENTS = 16
SERVE_REQUESTS = 200
SERVE_MAX_IDS = 16
SERVE_HOT = 256
# one bucket on the card against the CPU's eager forward of its blocks
SERVE_CPU_RTOL = 1e-4
SERVE_CPU_ATOL = 1e-5
# timed dispatches of one warm bucket
SERVE_WARM_RUNS = 50
# phase 10 (serving the zoo): ZOO_SERVE_CLIENTS threads of
# ZOO_SERVE_REQUESTS requests each on every path, at the serve defaults
# above, and ZOO_SERVE_WARM_RUNS timed warm dispatches
ZOO_SERVE_CLIENTS = 4
ZOO_SERVE_REQUESTS = 40
ZOO_SERVE_WARM_RUNS = 20
# phase 8 (remote and shared graphs): two shard processes over phase 5's
# ppi files, REMOTE_CHECK_IDS seeded ids read both ways, the JAX
# rolling-restart drill's schedule (tests/test_rolling_restart.py: shard 0
# after step 6, shard 1 after step 16) and loss tolerance, with its
# client settings, and a delta of up to REMOTE_DELTA_IDS served ids on
# shard 0
REMOTE_SHARDS = 2
REMOTE_CHECK_IDS = 1000
SHARD_WAIT_S = 180.0
DRILL_RESTARTS = {6: 0, 16: 1}
DRILL_LOSS_TOL = 0.4
DRILL_CLIENT = dict(retries=40, timeout_ms=2000, backoff_ms=10,
                    quarantine_ms=200, deadline_ms=90000,
                    rediscover_ms=250, neighbor_cache_mb=0)
REMOTE_DELTA_IDS = 64
BREAKDOWN_RUNS = 20
PPI_FEATURE_DIM = 50
PPI_LABEL_DIM = 121
# NVIDIA H100 SXM data-sheet peaks (700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def cuda_ms(fn, runs: int = 40, warmup: int = 10, batch: int = 10,
            before=None) -> float:
    """Median device milliseconds of ``fn()`` over ``runs`` event-timed
    runs (40: each run costs a 20 ms spin, and a median of 100 costs
    phase 3 over a minute more). A spin kernel (~20 ms per run) holds the
    card while the host enqueues each batch of runs, so every event pair
    times the device's work and not the host's launch overhead. A batch
    must stay within the card's queue of about a thousand pending
    launches. ``before()``, if given, runs ahead of each event pair,
    outside it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(0, runs, batch):
        torch.cuda._sleep(40_000_000 * batch)
        pairs = []
        for _ in range(batch):
            if before is not None:
                before()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        times += [a.elapsed_time(b) for a, b in pairs]
    return statistics.median(times)


def phase_env() -> str:
    log("== phase 1: environment")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs on the card only")
    from euler_tpu_torch import _build

    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1]}")
    try:
        import triton
        log(f"triton {triton.__version__}")
    except ImportError:
        log("triton: not importable")
    smi = smi_line()
    log(f"card: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False")
    return smi


def phase_build() -> None:
    """The CUDA kernels (nvcc) and, beside them on the host's cores, the
    graph engine (make), from the checkout's sources."""
    log("== phase 2: build")
    from euler_tpu_torch import _build
    from euler_tpu_torch.graph import native

    engine = {}

    def build_engine():
        t = time.perf_counter()
        try:
            native.build_native()
            engine["s"] = time.perf_counter() - t
        except Exception as e:  # raised below, on the main thread
            engine["error"] = e

    builder = threading.Thread(target=build_engine)
    builder.start()
    t0 = time.perf_counter()
    _build.load_library()
    log(f"built {_build.library_path()} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")
    builder.join()
    if "error" in engine:
        raise engine["error"]
    log(f"graph engine {native.library_path()} in {engine['s']:.2f} s "
        f"(make {native.build_seconds:.2f} s, 0 when it was built already; "
        "built beside nvcc)")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "error")):
            log(f"  ptxas: {line.strip()}")


def weighted_variant(data: dict, zero_rows, seed: int) -> dict:
    """The graph with random edge weights in [0.1, 1) and every edge of
    ``zero_rows`` weighted 0 (neighbors kept, no sampling mass)."""
    rng = np.random.default_rng(seed)
    out = dict(data)
    w = rng.uniform(0.1, 1.0, len(data["indices"])).astype(np.float32)
    for r in zero_rows:
        w[data["indptr"][r]:data["indptr"][r + 1]] = 0.0
    out["weights"] = w
    return out


def hetero_variant(data: dict, seed: int) -> dict:
    """The graph with each edge typed 0 or 1 by a seeded coin (each node's
    edges re-bucketed into its two (node, edge type) groups), node types
    drawn uniformly from ``HET_NODE_TYPES``, and a uint64 slot 0 holding
    each node's own id (so a sparse table of max_id + 2 rows embeds the
    ids, as run_loop's lshne sizes it)."""
    rng = np.random.default_rng(seed)
    n = len(data["node_weights"])
    rows = np.repeat(np.arange(n), np.diff(data["indptr"]))
    key = rows * 2 + rng.integers(0, 2, len(rows))
    order = np.argsort(key, kind="stable")
    indptr = np.zeros(2 * n + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=2 * n), out=indptr[1:])
    return dict(
        data, indptr=indptr, indices=data["indices"][order],
        weights=data["weights"][order], edge_type_num=2,
        node_types=rng.integers(0, HET_NODE_TYPES, n).astype(np.int32),
        sparse_features=[(np.arange(n + 1), np.arange(n))])


def check_members(adj: dict, rows, picks) -> None:
    """Every pick is a neighbor of its row (within the row's degree) or
    the default id."""
    n_rows, width = adj["nbr"].shape
    rows = torch.where(rows < 0, n_rows - 1, rows.clamp(max=n_rows - 1)).long()
    nbr = adj["nbr"][rows]                              # [M, W]
    in_deg = torch.arange(width, device=nbr.device) < adj["deg"][rows][:, None]
    hit = ((nbr[:, None, :] == picks[:, :, None]) & in_deg[:, None, :]).any(-1)
    ok = hit | (picks == n_rows - 1)
    if not bool(ok.all()):
        raise AssertionError(
            f"{int((~ok).sum())} picks are not neighbors of their rows")


def phase_kernel(seed: int, smi: str):
    log("== phase 3: kernel vs plain")
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_synthetic(**PPI)
    graph = MemoryGraph(**data)
    max_id = graph.max_node_id
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), dev)
    log(f"ppi graph {graph.num_nodes} nodes, {len(data['indices'])} edges, "
        f"slab {tuple(adj['nbr'].shape)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    n_rows = adj["nbr"].shape[0]
    default = n_rows - 1
    m, (f1, f2) = PPI_BATCH, PPI_FANOUTS
    gen = torch.Generator(device=dev).manual_seed(seed)
    words = device_graph.seed_words(seed + 12345)

    # (a) exactness on a weighted variant with zero-weight rows
    zero_rows = [5, 77]
    graph_w = MemoryGraph(**weighted_variant(data, zero_rows, seed))
    adj_w = device_graph.tensors(
        device_graph.build_adjacency(graph_w, [0], max_id), dev)
    if bool(adj_w["sampleable"][zero_rows].any()):
        raise AssertionError("zero-weight rows must not be sampleable")
    roots = torch.randint(0, max_id + 1, (m,), generator=gen, device=dev,
                          dtype=torch.int32)
    roots[:5] = torch.tensor([-7, n_rows + 100, default, 5, 77],
                             dtype=torch.int32, device=dev)
    # roots that hold the zero-weight rows as neighbors, so hop 2 can
    # reach them
    holders = [
        int(np.searchsorted(data["indptr"], pos[0], side="right") - 1)
        for pos in (np.flatnonzero(data["indices"] == z) for z in zero_rows)
        if len(pos)
    ]
    roots[5:5 + len(holders)] = torch.tensor(holders, dtype=torch.int32,
                                             device=dev)
    max_err = fanout2_exact(adj_w, roots, words, f1, f2, 5, gen, "a")

    # (b) Philox distribution of hop-1 picks for four fixed rows
    deg = adj_w["deg"]
    fixed = [int(deg.argmax()), 11, 1234, 40000]
    per_row = 10_000  # roots per row; x f1 = 10^5 draws per row
    roots_b = torch.tensor(fixed, dtype=torch.int32,
                           device=dev).repeat_interleave(per_row)
    h1, h2 = sampling_kernels.sample_fanout2(
        adj_w, adj_w, roots_b, device_graph.seed_words(seed + 99), f1, 1)
    check_members(adj_w, roots_b, h1)
    check_members(adj_w, h1.reshape(-1), h2)
    h1 = h1.reshape(len(fixed), -1)
    for i, r in enumerate(fixed):
        d = int(deg[r])
        cum = adj_w["cum"][r, :d].double()
        p = torch.diff(cum, prepend=cum.new_zeros(1))
        slot = (h1[i][:, None] == adj_w["nbr"][r, :d][None, :]).double()
        freq = slot.mean(0)
        tvd = 0.5 * float((freq - p).abs().sum())
        log(f"(b) row {r}: degree {d}, {h1.shape[1]} draws, TVD {tvd:.5f} "
            f"(bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"row {r}: TVD {tvd} >= {TVD_BOUND}")

    # (c) timing at the main path's shapes on the main path's slab, and
    # (h) exactness at the negatives' root count
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, -1, max_id), dev)
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    flush = torch.empty(FLUSH_BYTES // 4, device=dev).zero_
    width = adj["nbr"].shape[1]
    timed = []
    for mm in B1_ROOTS:
        if mm != m:
            odd = odd_nodes(mm, max_id, zero_rows, gen)
            max_err = max(max_err, fanout2_exact(
                adj_w, odd, words, f1, f2, 3 + len(zero_rows), None, "h"))
        roots_t = device_graph.sample_node(sampler, mm, generator=gen)
        if mm == m:
            roots_c = roots_t
        kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
            adj, adj, roots_t, words, f1, f2)
        plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
            adj, adj, roots_t, words, f1, f2)

        def library():  # one torch.multinomial per hop over gathered rows
            r1 = roots_t.long()
            i1 = torch.multinomial(probs[r1], f1, replacement=True)
            hop1 = adj["nbr"][r1].gather(1, i1).reshape(-1).long()
            i2 = torch.multinomial(probs[hop1], f2, replacement=True)
            return adj["nbr"][hop1].gather(1, i2)

        t = time_draw(kern, plain, library, mm * f1, flush)
        h1, h2 = kern()
        b = draw_bound(adj, ((roots_t, h1), (h1, h2)), mm)
        log(f"({'c' if mm == m else 'h'}) sample_fanout2 at [{mm}, {f1}, "
            f"{f2}], W={width}: {describe(t)}, {describe_bound(b)}")
        timed.append(dict(shape=[mm, f1, f2], **t, bound_ms=b["bound_ms"],
                          bound_by=b["bound_by"]))
    b2 = check_single_hop(adj, adj_w, roots, roots_c, zero_rows, seed, flush)
    wide = check_wide(seed)
    wide_slabs, wide_routes, wide_err = check_wide_draws(seed, flush, smi)
    reddit, reddit_timed, reddit_err = check_reddit_fanout(seed, flush)
    timed.append(reddit_timed)
    max_err = max(max_err, reddit_err, wide_err)
    b1 = dict(max_abs_err=max_err, exact_vs_plain=max_err == 0,
              **{k: v for k, v in timed[0].items() if k != "shape"},
              shapes=timed)
    b1["wide"], b2["wide"] = wide
    b2["max_abs_err"] = max(b2["max_abs_err"], wide_err)
    b2["exact_vs_plain"] = b2["max_abs_err"] == 0
    b1["wide_slabs"] = wide_slabs["sample_fanout2"]
    b2["wide_slabs"] = wide_slabs["sample_neighbor"]
    pl_graph = check_alias(seed)
    b2["shapes"].append(check_walks(adj, adj_w, sampler, zero_rows, seed,
                                    flush))
    check_biased(graph_w, pl_graph, zero_rows, seed)
    t0 = time.perf_counter()
    hetero = MemoryGraph(**hetero_variant(data, seed + 3))
    hetero_w = MemoryGraph(**hetero_variant(weighted_variant(data, zero_rows, seed),
                                      seed + 3))
    log(f"(n) heterogeneous ppi variants (2 edge types, {HET_NODE_TYPES} "
        f"node types, uint64 slot 0 = the node's id) built in "
        f"{time.perf_counter() - t0:.2f} s")
    het = check_hetero_draws(hetero, hetero_w, zero_rows, seed, flush)
    for b, (timed_h, err_h) in zip((b1, b2), het):
        b["shapes"] += timed_h
        b["max_abs_err"] = max(b["max_abs_err"], err_h)
        b["exact_vs_plain"] = b["max_abs_err"] == 0
    check_typed_negatives(hetero, seed)
    return graph, hetero, reddit, {"sample_fanout2": b1, "sample_neighbor": b2,
                                   "wide_routes": wide_routes}


def het_slabs(graph, dev) -> dict:
    """The et0, et1 and et0_1 slabs of a heterogeneous variant on ``dev``."""
    from euler_tpu_torch.graph import device as device_graph

    return {f"et{'_'.join(map(str, et))}": device_graph.tensors(
        device_graph.build_adjacency(graph, et, graph.max_node_id), dev)
        for et in ([0], [1], [0, 1])}


def check_hetero_draws(hetero, hetero_w, zero_rows, seed: int, flush):
    """Phase 3 (n): B1 over two distinct slabs of different widths (hop 1
    over et0 or et1, hop 2 over et0_1), as the lasgnn path launches it,
    equals ``sample_fanout2_reference`` exactly at [512, 10, 10] and
    [1,024, 10, 10], and B2 over et0 at [512, 1] (a step of lshne's
    walks) equals ``sample_neighbor_reference``, each with injected and
    Philox uniforms, on the weighted variant's slabs from roots led by a
    negative id, one past the slabs, the default row and zero-weight
    rows; then each is timed on the main paths' slabs as in (c). Returns
    (timing records, max |diff|) for B1, then for B2."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    dev = torch.device("cuda")
    max_id = hetero.max_node_id
    slabs, slabs_w = het_slabs(hetero, dev), het_slabs(hetero_w, dev)
    widths = {k: a["nbr"].shape[1] for k, a in slabs.items()}
    log(f"(n) slab widths {widths} (weighted variant "
        f"{ {k: a['nbr'].shape[1] for k, a in slabs_w.items()} })")
    if widths["et0"] == widths["et0_1"] or widths["et1"] == widths["et0_1"]:
        raise AssertionError(f"the hop slabs must differ in width: {widths}")
    gen = torch.Generator(device=dev).manual_seed(seed + 110)
    words = device_graph.stream_words(seed + 11011, (1 << 8) | 1)
    f1, f2 = PPI_FANOUTS
    max_err, timed = 0, []
    for first in ("et0", "et1"):
        for m in HET_B1_ROOTS:
            roots = odd_nodes(m, max_id, zero_rows, gen)
            max_err = max(max_err, fanout2_exact(
                slabs_w[first], roots, words, f1, f2, 3 + len(zero_rows),
                gen, "n", adj2=slabs_w["et0_1"]))
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(hetero, -1, max_id), dev)
    a2 = slabs["et0_1"]
    probs = {k: torch.diff(a["cum"], dim=1,
                           prepend=a["cum"].new_zeros(a["cum"].shape[0], 1))
             for k, a in slabs.items()}
    for first, m in (("et0", HET_B1_ROOTS[0]), ("et0", HET_B1_ROOTS[1]),
                     ("et1", HET_B1_ROOTS[1])):
        a1 = slabs[first]
        roots_t = device_graph.sample_node(sampler, m, generator=gen)
        kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
            a1, a2, roots_t, words, f1, f2)
        plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
            a1, a2, roots_t, words, f1, f2)

        def library():  # one torch.multinomial per hop over gathered rows
            r1 = roots_t.long()
            i1 = torch.multinomial(probs[first][r1], f1, replacement=True)
            hop1 = a1["nbr"][r1].gather(1, i1).reshape(-1).long()
            i2 = torch.multinomial(probs["et0_1"][hop1], f2,
                                   replacement=True)
            return a2["nbr"][hop1].gather(1, i2)

        t = time_draw(kern, plain, library, m * f1, flush)
        h1, h2 = kern()
        b = draw_bound(None, ((roots_t, h1), (h1, h2)), m, adjs=(a1, a2))
        log(f"(n) sample_fanout2 at [{m}, {f1}, {f2}] over {first} "
            f"(W={widths[first]}) then et0_1 (W={widths['et0_1']}): "
            f"{describe(t)}, {describe_bound(b)}")
        timed.append(dict(shape=[m, f1, f2], slabs=[first, "et0_1"],
                          width=[widths[first], widths["et0_1"]], **t,
                          bound_ms=b["bound_ms"], bound_by=b["bound_by"]))

    m, a = PPI_BATCH, slabs_w["et0"]
    nodes = odd_nodes(m, max_id, zero_rows, gen)
    u = torch.rand((m, 1), generator=gen, device=dev)
    b2_err = 0
    for mode, uu in (("injected", u), ("philox", None)):
        k = sampling_kernels.sample_neighbor(a, nodes, words, 1, hop=2, u=uu)
        p = sampling_kernels.sample_neighbor_reference(a, nodes, words, 1,
                                                       hop=2, u=uu)
        torch.cuda.synchronize()
        err = int((k - p).abs().max())
        b2_err = max(b2_err, err)
        if not torch.equal(k, p):
            raise AssertionError(f"sample_neighbor != plain over et0 at "
                                 f"[{m}, 1] ({mode}): max |diff| {err}")
        if not bool((k[:3 + len(zero_rows)] == max_id + 1).all()):
            raise AssertionError("unknown, default and zero-weight rows "
                                 "must draw the default id")
        check_members(a, nodes, k)
        log(f"(n) {mode} uniforms: sample_neighbor == plain at [{m}, 1] over "
            f"et0 (W={widths['et0']}), max |diff| {err}")
    a = slabs["et0"]
    nodes = device_graph.sample_node(sampler, m, generator=gen)
    rows = nodes.long()
    kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
        a, nodes, words, 1, hop=2)
    plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
        a, nodes, words, 1, hop=2)

    def library():  # one torch.multinomial over the gathered rows
        idx = torch.multinomial(probs["et0"][rows], 1, replacement=True)
        return a["nbr"][rows].gather(1, idx)

    t = time_draw(kern, plain, library, m, flush)
    b = draw_bound(a, ((nodes, kern()),), m)
    log(f"(n) sample_neighbor at [{m}, 1] over et0 (W={widths['et0']}): "
        f"{describe(t)}, {describe_bound(b)}")
    return (timed, max_err), ([dict(shape=[m, 1], slabs=["et0"],
                                    width=[widths["et0"]], **t,
                                    bound_ms=b["bound_ms"],
                                    bound_by=b["bound_by"])], b2_err)


def check_typed_negatives(hetero, seed: int) -> None:
    """Phase 3 (o): ``sample_node_with_src`` (plain PyTorch, no kernel)
    on CUDA tensors equals the same draw on CPU tensors bit for bit at
    the lshne shape (6,144 sources x 5, Philox uniforms), over the typed
    sampler of ``LSHNE_TYPES`` types; every pick has its source's type,
    sources of unknown type (a negative id, one past the table, the
    default row) draw type 0; no kernel launches. Prints its device
    time."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    max_id = hetero.max_node_id
    t0 = time.perf_counter()
    table = device_graph.build_typed_node_sampler(hetero, LSHNE_TYPES, max_id)
    gpu = device_graph.tensors(table, "cuda")
    cpu = device_graph.tensors(table, "cpu")
    log(f"(o) typed node sampler over {LSHNE_TYPES} types built in "
        f"{time.perf_counter() - t0:.2f} s: {int(table['off'][-1])} nodes, "
        f"{len(table['seg_cum'])} sub-segments")
    gen = torch.Generator(device="cuda").manual_seed(seed + 120)
    src = odd_nodes(LSHNE_PAIRS, max_id, [], gen)
    words = device_graph.stream_words(seed + 12012, 1)
    before = dict(sampling_kernels.launches)
    on_card = device_graph.sample_node_with_src(gpu, src, LSHNE_NEGS, words)
    torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in sampling_kernels.launches.items()}
    on_cpu = device_graph.sample_node_with_src(cpu, src.cpu(), LSHNE_NEGS,
                                               words)
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError(
            f"sample_node_with_src differs between CUDA and CPU in "
            f"{int((on_card.cpu() != on_cpu).sum())} picks")
    if any(launched.values()):
        raise AssertionError(f"sample_node_with_src launched {launched}")
    types = torch.as_tensor(table["types"])
    src_t = types[torch.where(src.cpu() < 0, max_id + 1,
                              src.cpu().clamp(max=max_id + 1)).long()]
    src_t = src_t.clamp(min=0)
    pick_t = types[on_cpu.long()]
    if not bool((pick_t == src_t[:, None]).all()):
        raise AssertionError("a typed negative is not of its source's type")
    # one draw a spin: its some 540 launches fill the card's queue
    ms = cuda_ms(lambda: device_graph.sample_node_with_src(
        gpu, src, LSHNE_NEGS, words), runs=50, batch=1)
    log(f"(o) philox uniforms: sample_node_with_src on CUDA == on CPU at "
        f"[{LSHNE_PAIRS}, {LSHNE_NEGS}], every pick of its source's type "
        f"(3 unknown-type sources drew type 0), launches {launched}; "
        f"{ms:.4f} ms on the card (CUDA events, median of 50)")


def fanout2_exact(adj_w, roots, words, f1: int, f2: int, n_default: int,
                  gen, tag: str, adj2=None) -> int:
    """B1 equals its plain version bit for bit on ``roots``, with Philox
    uniforms and, when ``gen`` is given, first with uniforms drawn from
    it; hop 2 draws from ``adj2`` (default: ``adj_w`` again). The first
    ``n_default`` roots draw the default id and every pick is a neighbor
    of its row. Returns the max |diff| (0)."""
    from euler_tpu_torch.graph import sampling_kernels

    adj2 = adj_w if adj2 is None else adj2
    m = roots.shape[0]
    default = adj_w["nbr"].shape[0] - 1
    modes = [("philox", (None, None))]
    if gen is not None:
        modes.insert(0, ("injected", (
            torch.rand((m, f1), generator=gen, device="cuda"),
            torch.rand((m * f1, f2), generator=gen, device="cuda"))))
    max_err = 0
    for mode, (a, b) in modes:
        k1, k2 = sampling_kernels.sample_fanout2(
            adj_w, adj2, roots, words, f1, f2, u1=a, u2=b)
        p1, p2 = sampling_kernels.sample_fanout2_reference(
            adj_w, adj2, roots, words, f1, f2, u1=a, u2=b)
        torch.cuda.synchronize()
        err = max(int((k1 - p1).abs().max()), int((k2 - p2).abs().max()))
        max_err = max(max_err, err)
        if not (torch.equal(k1, p1) and torch.equal(k2, p2)):
            raise AssertionError(f"kernel != plain at {m} roots ({mode} "
                                 f"uniforms): max |diff| {err}")
        if not bool((k1[:n_default] == default).all()):
            raise AssertionError("unknown, default and zero-weight roots "
                                 "must draw the default id")
        check_members(adj_w, roots, k1)
        check_members(adj2, k1.reshape(-1), k2)
        widths = (f"W={adj_w['nbr'].shape[1]}" if adj2 is adj_w else
                  f"W={adj_w['nbr'].shape[1]} then {adj2['nbr'].shape[1]}")
        log(f"({tag}) {mode} uniforms: kernel == plain at [{m}, {f1}] + "
            f"[{m * f1}, {f2}], {widths}, max |diff| {err}")
    return max_err


def check_reddit_fanout(seed: int, flush):
    """Phase 3 (j): builds the synthetic Reddit graph at ``bench.py``'s
    shape (W = 60 after the Poisson(50) clip), holds B1 against its plain
    version at [1,000, 4, 4] on a weighted variant with zero-weight rows,
    with injected and Philox uniforms, and times it on the main path's
    slab. Returns (the graph and its build seconds, the timing record,
    the max |diff|)."""
    from euler_tpu_torch.datasets import REDDIT, build_synthetic
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    data = build_synthetic(**REDDIT)
    graph = MemoryGraph(**data)
    build_s = time.perf_counter() - t0
    max_id = graph.max_node_id
    t0 = time.perf_counter()
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), dev)
    width = adj["nbr"].shape[1]
    log(f"(j) reddit graph {graph.num_nodes} nodes, {len(data['indices'])} "
        f"edges built in {build_s:.2f} s; slab {tuple(adj['nbr'].shape)} in "
        f"{time.perf_counter() - t0:.2f} s")
    zero_rows = [5, 77]
    adj_w = device_graph.tensors(device_graph.build_adjacency(
        MemoryGraph(**weighted_variant(data, zero_rows, seed)), [0], max_id), dev)
    del data
    m, (f1, f2) = REDDIT_BATCH, REDDIT_FANOUTS
    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    words = device_graph.seed_words(seed + 6060)
    roots = odd_nodes(m, max_id, zero_rows, gen)
    max_err = fanout2_exact(adj_w, roots, words, f1, f2, 3 + len(zero_rows),
                            gen, "j")
    del adj_w
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, -1, max_id), dev)
    roots_t = device_graph.sample_node(sampler, m, generator=gen)
    n_rows = adj["nbr"].shape[0]
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
        adj, adj, roots_t, words, f1, f2)
    plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
        adj, adj, roots_t, words, f1, f2)

    def library():  # one torch.multinomial per hop over gathered rows
        r1 = roots_t.long()
        i1 = torch.multinomial(probs[r1], f1, replacement=True)
        hop1 = adj["nbr"][r1].gather(1, i1).reshape(-1).long()
        i2 = torch.multinomial(probs[hop1], f2, replacement=True)
        return adj["nbr"][hop1].gather(1, i2)

    t = time_draw(kern, plain, library, m * f1, flush)
    h1, h2 = kern()
    b = draw_bound(adj, ((roots_t, h1), (h1, h2)), m)
    log(f"(j) sample_fanout2 at [{m}, {f1}, {f2}], W={width}: {describe(t)}, "
        f"{describe_bound(b)}")
    del adj, probs, sampler
    return ((graph, build_s),
            dict(shape=[m, f1, f2], width=width, **t, bound_ms=b["bound_ms"],
                 bound_by=b["bound_by"]), max_err)


def check_alias(seed: int) -> None:
    """Phase 3 (k): the plain alias draw (no kernel) on CUDA tensors
    equals the same draw on CPU tensors bit for bit, Philox uniforms, on
    a power-law graph with hub rows and random weights: single-hop draws
    and a two-hop fanout, on roots led by a negative id, one past the
    end, the default row, zero-weight rows and the hubs. Checks the int64
    Philox ops and the float32 slot arithmetic on the card; no kernel
    may launch."""
    from euler_tpu_torch.datasets import build_powerlaw
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    zero_rows = [5, 77]
    graph = MemoryGraph(**weighted_variant(build_powerlaw(**ALIAS_CHECK),
                                     zero_rows, seed))
    max_id = graph.max_node_id
    t0 = time.perf_counter()
    table = device_graph.build_alias_adjacency(graph, [0], max_id)
    hubs = np.argsort(table["deg"])[-4:].tolist()
    if table["deg"].max() < max(2048, graph.num_nodes // 64):
        raise AssertionError("the alias check graph has no hub row")
    log(f"(k) power-law graph {graph.num_nodes} nodes, "
        f"{len(table['nbr'])} edges, max degree {table['deg'].max()}, alias "
        f"tables in {time.perf_counter() - t0:.2f} s")
    cpu = device_graph.tensors(table, "cpu")
    gpu = device_graph.tensors(table, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 70)
    roots = odd_nodes(REDDIT_BATCH, max_id, zero_rows + hubs, gen)
    n_default = 3 + len(zero_rows)
    words = device_graph.seed_words(seed + 7070)
    f1, f2 = REDDIT_FANOUTS
    before = dict(sampling_kernels.launches)
    on_card = [device_graph.sample_neighbor(gpu, roots, f1, words, hop=2)]
    on_card += device_graph.sample_fanout([gpu, gpu], roots, [f1, f2], words)
    on_cpu = [device_graph.sample_neighbor(cpu, roots.cpu(), f1, words, hop=2)]
    on_cpu += device_graph.sample_fanout([cpu, cpu], roots.cpu(), [f1, f2],
                                         words)
    torch.cuda.synchronize()
    if sampling_kernels.launches != before:
        raise AssertionError("an alias draw launched a kernel")
    for name, a, b in zip(("single hop", "roots", "hop 1", "hop 2"),
                          on_card, on_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(
                f"alias draw ({name}) differs between CUDA and CPU: max "
                f"|diff| {int((a.cpu() - b).abs().max())}")
    single = on_card[0]
    if not bool((single[:n_default] == max_id + 1).all()):
        raise AssertionError("unknown, default and zero-weight rows must "
                             "draw the default id")
    if bool((single[n_default:n_default + len(hubs)] == max_id + 1).any()):
        raise AssertionError("a hub row drew the default id")
    log(f"(k) philox uniforms: alias draw on CUDA == on CPU at "
        f"[{REDDIT_BATCH}, {f1}] (hop 2) and the [{f1}, {f2}] fanout "
        f"(hops {[int(h.numel()) for h in on_card[1:]]}), no launch")
    return graph


def check_walks(adj, adj_w, sampler, zero_rows, seed: int, flush) -> dict:
    """Phase 3 (l): ``random_walk`` at node2vec's shape (15,360 walkers,
    walk_len 5) on the weighted ppi slab held as CUDA tensors equals the
    same walk over CPU tensors bit for bit (the kernel against its plain
    version, one Philox stream), from roots led by a negative id, one
    past the slab, the default row and the zero-weight rows, with exactly
    one B2 launch a step; then B2 timed at [15,360, 1] on the main path's
    slab, on step-1 picks of a walk from sampled roots. Returns the
    timing record."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 80)
    max_id = adj["nbr"].shape[0] - 2
    m, steps = N2V_ROOTS, N2V_WALK_LEN
    words = device_graph.stream_words(seed + 8080, 0)
    roots = odd_nodes(m, max_id, zero_rows, gen)
    before = sampling_kernels.launches["sample_neighbor"]
    on_card = device_graph.random_walk(adj_w, roots, steps, words)
    torch.cuda.synchronize()
    launched = sampling_kernels.launches["sample_neighbor"] - before
    on_cpu = device_graph.random_walk(
        {k: v.cpu() for k, v in adj_w.items()}, roots.cpu(), steps, words)
    if launched != steps:
        raise AssertionError(f"a {steps}-step walk launched B2 {launched} "
                             "times")
    if not torch.equal(on_card.cpu(), on_cpu):
        raise AssertionError(
            f"random_walk differs between CUDA and CPU in "
            f"{int((on_card.cpu() != on_cpu).sum())} picks")
    if not bool((on_card[:3 + len(zero_rows), 1:] == max_id + 1).all()):
        raise AssertionError("unknown, default and zero-weight roots must "
                             "walk the default row")
    for t in range(steps):
        check_members(adj_w, on_card[:, t], on_card[:, t + 1:t + 2])
    log(f"(l) philox uniforms: random_walk on CUDA == on CPU at [{m}, "
        f"{steps + 1}], {launched} B2 launches, every pick a neighbor")

    nodes = device_graph.random_walk(
        adj, device_graph.sample_node(sampler, m, generator=gen), 1,
        words)[:, 1].contiguous()
    n_rows, width = adj["nbr"].shape
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    rows = nodes.long()
    kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
        adj, nodes, words, 1, hop=1)
    plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
        adj, nodes, words, 1, hop=1)

    def library():  # one torch.multinomial over the gathered rows
        idx = torch.multinomial(probs[rows], 1, replacement=True)
        return adj["nbr"][rows].gather(1, idx)

    t = time_draw(kern, plain, library, m, flush)
    b = draw_bound(adj, ((nodes, kern()),), m)
    log(f"(l) sample_neighbor at [{m}, 1], W={width}: {describe(t)}, "
        f"{describe_bound(b)}")
    return dict(shape=[m, 1], **t, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"])


def analytic_biased_joint(nbr, cum, deg, root: int, p: float, q: float):
    """Exact P(c1, c2) of a 2-step node2vec walk from ``root`` over a
    slab's numpy arrays: step 1 plain weighted, step 2 reweighted by d_tx
    against the parent ``root`` (1 for a neighbor of the root, which wins
    on a root self-loop; 1/p for the root; 1/q otherwise)."""
    def row_probs(v):
        d = deg[v]
        w = np.diff(cum[v][:d].astype(np.float64), prepend=0.0)
        return nbr[v][:d], w / w.sum()

    joint = {}
    root_nbrs = set(nbr[root][:deg[root]].tolist())
    for c1, p1 in zip(*row_probs(root)):
        cands, w2 = row_probs(int(c1))
        scale = np.array([1.0 if c in root_nbrs
                          else (1.0 / p if c == root else 1.0 / q)
                          for c in cands])
        w2 = w2 * scale / (w2 * scale).sum()
        for c2, pr in zip(cands, w2):
            key = (int(c1), int(c2))
            joint[key] = joint.get(key, 0.0) + p1 * pr
    return joint


def check_biased(graph_w, pl_graph, zero_rows, seed: int) -> None:
    """Phase 3 (m): the biased walks, plain PyTorch on the card, no kernel
    launch. ``biased_random_walk`` over the weighted ppi graph's sorted
    slab: the 2-step joint of 10^5 walkers from one root against
    ``analytic_biased_joint`` (TVD bound ``TVD_BOUND``), for each (p, q)
    of ``BIASED_PQ``; then at node2vec's 15,360 walkers and walk_len 5 on
    CUDA against CPU, where float32 cumsums may round apart: the
    differing picks are counted and every pick must be a legal
    transition. ``alias_biased_random_walk`` over the 9,000-node
    power-law graph's sorted alias tables (64 trials) equals the same
    walk on CPU tensors bit for bit."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    before = dict(sampling_kernels.launches)
    max_id = graph_w.max_node_id
    table = device_graph.build_adjacency(graph_w, [0], max_id, sorted=True)
    nbr, cum, deg = table["nbr"], table["cum"], table["deg"]
    # the root: a small joint (few cells for 10^5 draws), every neighbor
    # a live row; a self-loop root where there is one, so the d_tx = 1
    # precedence is in the joint
    live = table["sampleable"] & (deg > 0)
    real = np.arange(nbr.shape[1])[None, :] < deg[:, None]
    cells = deg[nbr].sum(1)  # padding is the default row, of degree 0
    ok = ((deg >= 4) & live & np.where(real, live[nbr], True).all(1)
          & (cells <= 120))
    loops = ok & (real & (nbr == np.arange(len(nbr))[:, None])).any(1)
    pool = np.flatnonzero(loops if loops.any() else ok)
    root = int(pool[np.argmin(cells[pool])])
    gpu = device_graph.tensors(table, "cuda")
    cpu = device_graph.tensors(table, "cpu")
    n = BIASED_WALKERS
    n_rows = max_id + 2
    for i, (p, q) in enumerate(BIASED_PQ):
        walks = device_graph.biased_random_walk(
            gpu, torch.full((n,), root, dtype=torch.int32, device="cuda"), 2,
            p, q, device_graph.seed_words(seed + 90 + i))
        keys, counts = torch.unique(walks[:, 1].long() * n_rows
                                    + walks[:, 2].long(), return_counts=True)
        seen = {(int(k) // n_rows, int(k) % n_rows): int(c) / n
                for k, c in zip(keys.cpu(), counts.cpu())}
        want = analytic_biased_joint(nbr, cum, deg, root, p, q)
        if set(seen) - set(want):
            raise AssertionError(f"illegal 2-step transitions from {root}: "
                                 f"{sorted(set(seen) - set(want))[:5]}")
        tvd = 0.5 * sum(abs(seen.get(k, 0.0) - v) for k, v in want.items())
        log(f"(m) biased_random_walk (p, q) = ({p}, {q}) from root {root} "
            f"(degree {deg[root]}, self-loop "
            f"{bool((nbr[root, :deg[root]] == root).any())}, {len(want)} "
            f"cells): {n} walkers, TVD {tvd:.5f} (bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"biased walk TVD {tvd} >= {TVD_BOUND}")

    gen = torch.Generator(device="cuda").manual_seed(seed + 91)
    roots = odd_nodes(N2V_ROOTS, max_id, zero_rows, gen)
    words = device_graph.stream_words(seed + 9191, 0)
    for p, q in BIASED_PQ:
        a = device_graph.biased_random_walk(gpu, roots, N2V_WALK_LEN, p, q,
                                            words)
        b = device_graph.biased_random_walk(cpu, roots.cpu(), N2V_WALK_LEN,
                                            p, q, words)
        for t in range(N2V_WALK_LEN):
            check_members(gpu, a[:, t], a[:, t + 1:t + 2])
        differ = int((a.cpu() != b).sum())
        log(f"(m) biased_random_walk (p, q) = ({p}, {q}) at "
            f"[{N2V_ROOTS}, {N2V_WALK_LEN + 1}] on CUDA against CPU: "
            f"{differ} of {b.numel()} picks differ (float32 cumsum "
            f"rounding), every CUDA pick a legal transition")

    max_id = pl_graph.max_node_id
    t0 = time.perf_counter()
    table = device_graph.build_alias_adjacency(pl_graph, [0], max_id,
                                               sorted=True)
    gpu = device_graph.tensors(table, "cuda")
    cpu = device_graph.tensors(table, "cpu")
    hubs = np.argsort(table["deg"])[-4:].tolist()
    roots = odd_nodes(4096, max_id, hubs, gen)
    words = device_graph.stream_words(seed + 9292, 0)
    for p, q in BIASED_PQ:
        a = device_graph.alias_biased_random_walk(gpu, roots, N2V_WALK_LEN,
                                                  p, q, seed_words=words)
        b = device_graph.alias_biased_random_walk(
            cpu, roots.cpu(), N2V_WALK_LEN, p, q, seed_words=words)
        if not torch.equal(a.cpu(), b):
            raise AssertionError(
                f"alias_biased_random_walk (p, q) = ({p}, {q}) differs "
                f"between CUDA and CPU in {int((a.cpu() != b).sum())} picks")
        log(f"(m) philox uniforms: alias_biased_random_walk (p, q) = ({p}, "
            f"{q}), {device_graph.DEFAULT_WALK_TRIALS} trials, on CUDA == on "
            f"CPU at [4096, {N2V_WALK_LEN + 1}] over sorted alias tables "
            f"(max degree {table['deg'].max()}, "
            f"{table['bisect_steps'].shape[0]} bisection steps)")
    torch.cuda.synchronize()
    if sampling_kernels.launches != before:
        raise AssertionError("a biased walk launched a kernel")
    log(f"(m) no kernel launched; alias part {time.perf_counter() - t0:.2f} s")


def wide_slab(n_rows: int, width: int, seed: int) -> dict:
    """A [n_rows, width] slab on the card in ``build_adjacency``'s
    layout: row r has a random degree in [1, width] (the widest rows
    full) of random neighbors with weights in [0.1, 1); padding slots
    hold the default id and cum 1; row 1 has zero weight (not
    sampleable); the last row is the default."""
    from euler_tpu_torch.graph import device as device_graph

    rng = np.random.default_rng(seed)
    default = n_rows - 1
    deg = rng.integers(1, width + 1, n_rows)
    deg[:n_rows // 4] = width
    deg[default] = 0
    live = np.arange(width)[None, :] < deg[:, None]
    w = np.where(live, rng.uniform(0.1, 1.0, (n_rows, width)), 0.0)
    cum = np.cumsum(w, 1) / np.maximum(w.sum(1, keepdims=True), 1e-30)
    cum = np.where(live, cum, 1.0).astype(np.float32)
    cum[np.arange(n_rows), np.maximum(deg - 1, 0)] = 1.0
    nbr = np.where(live, rng.integers(0, default, (n_rows, width)), default)
    ok = deg > 0
    ok[1] = False
    cum[1] = 1.0
    return device_graph.tensors(dict(
        nbr=nbr.astype(np.int32), cum=cum, sampleable=ok,
        deg=deg.astype(np.int32)), torch.device("cuda"))


def check_wide(seed: int):
    """Phase 3 (i): the chained and the single-hop kernels equal their
    plain versions, Philox uniforms, on slabs wider than the main paths'
    (``WIDE_WIDTHS``), at the main paths' counts. Returns the warm times,
    by kernel, as lists of {"width", "shape", "ms"}."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    words = device_graph.seed_words(seed + 4321)
    f1, f2 = PPI_FANOUTS
    m1, (m2, count) = PPI_BATCH, B2_SHAPES[1]
    out = ([], [])
    for width in WIDE_WIDTHS:
        adj = wide_slab(8192, width, seed + width)
        max_id = adj["nbr"].shape[0] - 2
        roots = odd_nodes(m1, max_id, [1], gen)
        nodes = odd_nodes(m2, max_id, [1], gen)
        runs = (
            ("sample_fanout2", [m1, f1, f2], lambda: sampling_kernels
             .sample_fanout2(adj, adj, roots, words, f1, f2),
             lambda: sampling_kernels.sample_fanout2_reference(
                 adj, adj, roots, words, f1, f2)),
            ("sample_neighbor", [m2, count], lambda: sampling_kernels
             .sample_neighbor(adj, nodes, words, count, hop=1),
             lambda: sampling_kernels.sample_neighbor_reference(
                 adj, nodes, words, count, hop=1)),
        )
        for (name, shape, kern, plain), times in zip(runs, out):
            k, p = kern(), plain()
            k, p = (k, p) if name == "sample_neighbor" else (
                torch.cat([k[0].reshape(-1), k[1].reshape(-1)]),
                torch.cat([p[0].reshape(-1), p[1].reshape(-1)]))
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{name} != plain at {shape}, W={width} (philox): max "
                    f"|diff| {int((k - p).abs().max())}")
            ms = cuda_ms(kern)
            log(f"(i) philox uniforms: {name} == plain at {shape}, "
                f"W={width}; kernel {ms:.5f} ms warm")
            times.append(dict(width=width, shape=shape, ms=ms))
    return out


def neighbor_exact(adj, nodes, words, count: int, hop: int, n_default: int,
                   gen, tag: str) -> int:
    """B2 equals its plain version bit for bit on ``nodes``, with uniforms
    drawn from ``gen`` and with Philox; the first ``n_default`` nodes draw
    the default id and every pick is a neighbor of its row. Returns the
    max |diff| (0)."""
    from euler_tpu_torch.graph import sampling_kernels

    m = nodes.shape[0]
    default = adj["nbr"].shape[0] - 1
    max_err = 0
    for mode, u in (("injected", torch.rand((m, count), generator=gen,
                                             device="cuda")),
                    ("philox", None)):
        k = sampling_kernels.sample_neighbor(adj, nodes, words, count,
                                             hop=hop, u=u)
        p = sampling_kernels.sample_neighbor_reference(adj, nodes, words,
                                                       count, hop=hop, u=u)
        torch.cuda.synchronize()
        err = int((k - p).abs().max())
        max_err = max(max_err, err)
        if not torch.equal(k, p):
            raise AssertionError(f"({tag}) sample_neighbor != plain at [{m}, "
                                 f"{count}] ({mode}): max |diff| {err}")
        if not bool((k[:n_default] == default).all()):
            raise AssertionError("unknown, default and zero-weight rows "
                                 "must draw the default id")
        check_members(adj, nodes, k)
        log(f"({tag}) {mode} uniforms: sample_neighbor == plain at [{m}, "
            f"{count}], hop {hop}, W={adj['nbr'].shape[1]}, max |diff| {err}")
    return max_err


def check_wide_draws(seed: int, flush, smi: str):
    """Phase 3 (p)-(q): the wide path (slabs past the register layout's
    1,024 slots). (p) On synthetic slabs of ``WIDE_DRAW_ROWS`` rows at each
    width of ``WIDE_DRAW_WIDTHS`` (``wide_slab``: random degrees up to the
    width, a quarter of the rows full), B1 at ``WIDE_B1_SHAPES`` and B2 at
    ``WIDE_B2_SHAPES`` equal their plain versions bit for bit with injected
    and Philox uniforms on odd roots, so does B1 at [512, 10, 10] over
    two slabs of mixed width (a ``WIDE_MIXED_NARROW`` slab, then the wide
    one, and the reverse), B1 equals two chained B2 launches, and each
    shape is timed as ``time_draw`` does (a median of
    ``WIDE_TIMED_RUNS``), with the bound counted over each row's degree
    (``draw_bound(by_deg=True)``); at the widest, the slot frequencies of
    ``WIDE_FREQ_DRAWS`` B2 draws from one full-width row pass a chi-square
    test against its ``cum`` probabilities. (q) At the narrowest width the
    sharded routes (a rank's [256, 10, 10] and [256, 1], data row 1 of 2)
    equal their plain versions at the rank's folded words. Returns
    ({kernel: [records]}, {route: record}, the max |diff| (0))."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph
    from euler_tpu_torch.parallel import mesh as mesh_mod

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    words = device_graph.seed_words(seed + 1919)
    out = {"sample_fanout2": [], "sample_neighbor": []}
    routes = {}
    max_err = 0
    for width in WIDE_DRAW_WIDTHS:
        t0 = time.perf_counter()
        adj = wide_slab(WIDE_DRAW_ROWS, width, seed + width)
        n_rows = adj["nbr"].shape[0]
        max_id = n_rows - 2
        log(f"(p) synthetic slab [{n_rows}, {width}] ({table_bytes(adj)} B, "
            f"mean degree {float(adj['deg'].float().mean()):.1f}) built in "
            f"{time.perf_counter() - t0:.2f} s")
        for m, f1, f2 in WIDE_B1_SHAPES:
            max_err = max(max_err, fanout2_exact(
                adj, odd_nodes(m, max_id, [1], gen), words, f1, f2, 4, gen,
                "p"))
        for hop, (m, count) in enumerate(WIDE_B2_SHAPES):
            max_err = max(max_err, neighbor_exact(
                adj, odd_nodes(m, max_id, [1], gen), words, count, hop, 4,
                gen, "p"))
        m, f1, f2 = WIDE_B1_SHAPES[0]
        # a metapath's two slabs of one id space, one within the register
        # layout and one past it, in both orders
        narrow = wide_slab(WIDE_DRAW_ROWS, WIDE_MIXED_NARROW, seed + 1)
        for a1, a2 in ((narrow, adj), (adj, narrow)):
            max_err = max(max_err, fanout2_exact(
                a1, odd_nodes(m, max_id, [1], gen), words, f1, f2, 4, gen,
                "p", adj2=a2))
        del narrow
        roots = odd_nodes(m, max_id, [1], gen)
        h1, h2 = sampling_kernels.sample_fanout2(adj, adj, roots, words, f1,
                                                 f2)
        s1 = sampling_kernels.sample_neighbor(adj, roots, words, f1, hop=0)
        s2 = sampling_kernels.sample_neighbor(adj, s1.reshape(-1), words, f2,
                                              hop=1)
        if not (torch.equal(h1, s1) and torch.equal(h2, s2)):
            raise AssertionError(f"(p) W={width}: sample_fanout2 != two "
                                 "chained sample_neighbor launches")
        log(f"(p) W={width}: sample_fanout2 == sample_neighbor at hop 0 then "
            f"hop 1, [{m}, {f1}] + [{m * f1}, {f2}] bit for bit")

        probs = torch.diff(adj["cum"], dim=1,
                           prepend=adj["cum"].new_zeros(n_rows, 1))

        def multinomial(rows, count):  # over the gathered rows
            idx = torch.multinomial(probs[rows], count, replacement=True)
            return adj["nbr"][rows].gather(1, idx)

        for m, f1, f2 in WIDE_B1_SHAPES:
            r = torch.randint(0, max_id + 1, (m,), generator=gen,
                              device="cuda", dtype=torch.int32)
            kern = lambda: sampling_kernels.sample_fanout2(  # noqa: E731
                adj, adj, r, words, f1, f2)
            plain = lambda: sampling_kernels.sample_fanout2_reference(  # noqa: E731
                adj, adj, r, words, f1, f2)
            library = lambda: multinomial(  # noqa: E731
                multinomial(r.long(), f1).reshape(-1).long(), f2)
            t = time_draw(kern, plain, library, m * KERNEL_WARPS, flush,
                          WIDE_TIMED_RUNS)
            h1, h2 = kern()
            b = draw_bound(adj, ((r, h1), (h1, h2)), m, by_deg=True)
            log(f"(p) sample_fanout2 at [{m}, {f1}, {f2}], W={width}: "
                f"{describe(t)}, {describe_bound(b)} (card: {smi})")
            out["sample_fanout2"].append(dict(
                width=width, shape=[m, f1, f2], **t, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"]))
        for hop, (m, count) in enumerate(WIDE_B2_SHAPES):
            r = torch.randint(0, max_id + 1, (m,), generator=gen,
                              device="cuda", dtype=torch.int32)
            kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
                adj, r, words, count, hop=hop)
            plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
                adj, r, words, count, hop=hop)
            library = lambda: multinomial(r.long(), count)  # noqa: E731
            t = time_draw(kern, plain, library, m * KERNEL_WARPS, flush,
                          WIDE_TIMED_RUNS)
            b = draw_bound(adj, ((r, kern()),), m, by_deg=True)
            log(f"(p) sample_neighbor at [{m}, {count}], W={width}: "
                f"{describe(t)}, {describe_bound(b)} (card: {smi})")
            out["sample_neighbor"].append(dict(
                width=width, shape=[m, count], **t, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"]))
        del probs

        if width == WIDE_DRAW_WIDTHS[-1]:
            # slot frequencies of one full-width row, its slots named by
            # their index so that a pick says which slot it came from
            row = int(torch.nonzero(adj["deg"] == width)[0])
            freq_adj = dict(adj, nbr=adj["nbr"].clone())
            freq_adj["nbr"][row] = torch.arange(width, dtype=torch.int32,
                                                device="cuda")
            count = 10
            nodes = torch.full((WIDE_FREQ_DRAWS // count,), row,
                               dtype=torch.int32, device="cuda")
            picks = sampling_kernels.sample_neighbor(
                freq_adj, nodes, device_graph.stream_words(seed + 77, 1),
                count)
            hits = torch.bincount(picks.reshape(-1).long(),
                                  minlength=width).double()
            cum = adj["cum"][row].double()
            p_slot = torch.diff(cum, prepend=cum.new_zeros(1))
            expect = p_slot * picks.numel()
            live = p_slot > 0
            chi2 = float((((hits - expect) ** 2)[live] / expect[live]).sum())
            dof = int(live.sum()) - 1
            bound = dof + CHI2_SIGMAS * (2 * dof) ** 0.5
            log(f"(p) W={width}: {picks.numel()} draws from full-width row "
                f"{row}: chi-square {chi2:.1f} over {dof} degrees of freedom "
                f"(bound {bound:.1f}, the mean plus {CHI2_SIGMAS} standard "
                f"deviations); picks of zero-probability slots "
                f"{int(hits[~live].sum())}")
            if not (chi2 < bound and int(hits[~live].sum()) == 0
                    and hits.numel() == width):
                raise AssertionError(f"(p) W={width}: slot frequencies off")
            del freq_adj, picks

        if width == WIDE_DRAW_WIDTHS[0]:
            # (q) the sharded routes at a rank's shapes, data row 1 of 2
            mesh = mesh_mod.Mesh(2, rank=1)
            per = PPI_BATCH // 2
            r = torch.randint(0, max_id + 1, (per,), generator=gen,
                              device="cuda", dtype=torch.int32)
            fold = sampling_kernels.folded_words(words, 1)
            f1, f2 = PPI_FANOUTS
            for name, kern, plain in (
                    ("sample_fanout2_sharded",
                     lambda: sampling_kernels.sample_fanout2_sharded(
                         adj, adj, r, words, f1, f2, mesh),
                     lambda: sampling_kernels.sample_fanout2_reference(
                         adj, adj, r, fold, f1, f2)),
                    ("sample_neighbor_sharded",
                     lambda: sampling_kernels.sample_neighbor_sharded(
                         adj, r, words, 1, mesh),
                     lambda: sampling_kernels.sample_neighbor_reference(
                         adj, r, fold, 1))):
                before = dict(sampling_kernels.sharded_launches)
                got, want = kern(), plain()
                if name == "sample_fanout2_sharded":
                    err = max(int((got[0] - want[0]).abs().max()),
                              int((got[1] - want[1]).abs().max()))
                    shape = [per, f1, f2]
                else:
                    err, shape = int((got - want).abs().max()), [per, 1]
                launched = sampling_kernels.sharded_launches[name] - before[
                    name]
                if err or launched != int(r.is_cuda):
                    raise AssertionError(f"(q) {name} at W={width}: max "
                                         f"|diff| {err}, launches "
                                         f"{sampling_kernels.sharded_launches}")
                routes[name] = dict(width=width, shape=shape, max_abs_err=err,
                                    ms=cuda_ms(kern, WIDE_TIMED_RUNS))
                log(f"(q) {name} at a rank's {shape} (data row 1 of 2), "
                    f"W={width}: == plain at the folded words, one launch, "
                    f"{routes[name]['ms']:.5f} ms warm (card: {smi})")
        del adj
    return out, routes, max_err


def odd_nodes(m: int, max_id: int, zero_rows, gen) -> torch.Tensor:
    """[m] int32 ids on the card: random real ids, led by a negative id,
    one past the slab, the default row and the zero-weight rows."""
    n_rows = max_id + 2
    nodes = torch.randint(0, max_id + 1, (m,), generator=gen, device="cuda",
                          dtype=torch.int32)
    odd = [-7, n_rows + 100, n_rows - 1, *zero_rows]
    nodes[:len(odd)] = torch.tensor(odd, dtype=torch.int32, device="cuda")
    return nodes


def draw_bound(adj, hops, ids: int, adjs=None, by_deg: bool = False) -> dict:
    """The least time the card could take for weighted draws over the slab
    ``adj`` (or hop h over ``adjs[h]``), from this run's picks; ``hops``
    holds one (rows, picks [len(rows), count]) pair per hop. Bytes: the
    ``ids`` roots read, the cum row and sampleable flag of each distinct
    row of each slab read once, one 4-byte nbr entry per distinct (row,
    picked id) of a sampleable row of each slab (the draw counts on cum,
    then reads only the slot it chose), every pick written. Operations:
    one u >= cum compare per slot of its slab and draw. ``by_deg`` (the
    wide path over a slab with ``deg``) counts a row's first deg[row]
    slots and its 4-byte deg instead of the slab's width: the slots a
    draw of that row needs."""
    adjs = list(adjs) if adjs is not None else [adj] * len(hops)
    by_slab = {}
    for a, hop in zip(adjs, hops):
        by_slab.setdefault(id(a), (a, []))[1].append(hop)
    uniq_rows = reads = row_bytes = ops = 0
    for a, slab_hops in by_slab.values():
        n_rows, width = a["nbr"].shape
        default = n_rows - 1
        rows = [torch.where(r.reshape(-1) < 0, default,
                            r.reshape(-1).clamp(max=default)).long()
                for r, _ in slab_hops]
        uniq_ids = torch.unique(torch.cat(rows))
        uniq = int(uniq_ids.numel())
        uniq_rows += uniq
        if by_deg:
            slots = a["deg"].long().clamp(0, width)
            row_bytes += int(4 * slots[uniq_ids].sum()) + uniq * (4 + 1)
            ops += sum(int(slots[r].sum()) * p.shape[-1]
                       for r, (_, p) in zip(rows, slab_hops))
        else:
            row_bytes += uniq * (4 * width + 1)
            ops += sum(p.numel() for _, p in slab_hops) * width
        keys = []
        for r, (_, p) in zip(rows, slab_hops):
            key = r[:, None] * n_rows + p.long()
            keys.append(key[a["sampleable"][r]])
        reads += int(torch.unique(torch.cat(keys)).numel())
    picks = sum(p.numel() for _, p in hops)
    bytes_moved = 4 * ids + row_bytes + 4 * reads + 4 * picks
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=bytes_moved, compares=ops, rows=uniq_rows, reads=reads)


def describe_bound(b: dict) -> str:
    return (f"bound {b['bound_ms'] * 1e3:.3f} us ({b['bound_by']}: "
            f"{b['bytes']} B over {b['rows']} distinct rows and {b['reads']} "
            f"distinct nbr reads, {b['compares']} compares)")


def floor_launch(warps: int):
    """A callable that launches the empty kernel at the grid a draw
    kernel of ``warps`` warps takes."""
    from euler_tpu_torch import _build

    lib = _build.load_library()

    def launch():
        rc = lib.etpu_launch_floor(warps,
                                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
    return launch


def time_draw(kern, plain, library, warps: int, flush,
              runs: int = 40) -> dict:
    """A draw kernel warm (``ms``), with ``flush()`` evicting the L2 cache
    before each launch (``ms_cold``), the empty kernel at its grid
    (``floor_ms``), its plain version and its library yardstick, each the
    median of ``runs``."""
    return dict(
        ms=cuda_ms(kern, runs), ms_cold=cuda_ms(kern, runs, before=flush),
        floor_ms=cuda_ms(floor_launch(warps), runs),
        plain_ms=cuda_ms(plain, runs, batch=1),  # 300-600 launches a run
        library_ms=cuda_ms(library, runs))


def describe(t: dict) -> str:
    return (f"kernel {t['ms']:.5f} ms warm, {t['ms_cold']:.5f} ms cold, "
            f"empty launch {t['floor_ms']:.5f} ms, plain {t['plain_ms']:.4f} "
            f"ms, torch.multinomial {t['library_ms']:.4f} ms")


def check_single_hop(adj, adj_w, roots, roots_c, zero_rows, seed, flush):
    """Phase 3 (d)-(g): the single-hop kernel against its plain version,
    against the chained kernel, against the cum probabilities, and timed
    (``flush`` evicts the L2 cache for the cold times). Returns the
    kernel's numbers at the unsupervised positives' shape and, under
    ``shapes``, at every shape of ``B2_SHAPES``."""
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    max_id = adj["nbr"].shape[0] - 2
    words = device_graph.stream_words(seed + 555, 1)

    # (d) exactness at both shapes, injected and Philox uniforms
    max_err = 0
    for hop, (m, count) in enumerate(B2_SHAPES):
        max_err = max(max_err, neighbor_exact(
            adj_w, odd_nodes(m, max_id, zero_rows, gen), words, count, hop,
            3 + len(zero_rows), gen, "d"))

    # (e) the chained kernel is two single-hop launches
    f1, f2 = PPI_FANOUTS
    h1, h2 = sampling_kernels.sample_fanout2(adj_w, adj_w, roots, words, f1,
                                             f2)
    s1 = sampling_kernels.sample_neighbor(adj_w, roots, words, f1, hop=0)
    s2 = sampling_kernels.sample_neighbor(adj_w, s1.reshape(-1), words, f2,
                                          hop=1)
    if not (torch.equal(h1, s1) and torch.equal(h2, s2)):
        raise AssertionError("sample_fanout2 != two chained sample_neighbor "
                             "launches (Philox)")
    log(f"(e) sample_fanout2 == sample_neighbor at hop 0 then hop 1: "
        f"[{roots.shape[0]}, {f1}] + [{h2.shape[0]}, {f2}] bit for bit")

    # (f) Philox pick distribution of four fixed rows, 10^5 draws each
    deg = adj_w["deg"]
    fixed = [int(deg.argmax()), 11, 1234, 40000]
    per_row, count = 10_000, 10
    nodes = torch.tensor(fixed, dtype=torch.int32,
                         device="cuda").repeat_interleave(per_row)
    picks = sampling_kernels.sample_neighbor(
        adj_w, nodes, device_graph.stream_words(seed + 99, 2), count)
    check_members(adj_w, nodes, picks)
    picks = picks.reshape(len(fixed), -1)
    for i, r in enumerate(fixed):
        d = int(deg[r])
        cum = adj_w["cum"][r, :d].double()
        p = torch.diff(cum, prepend=cum.new_zeros(1))
        freq = (picks[i][:, None] == adj_w["nbr"][r, :d][None, :]).double()
        tvd = 0.5 * float((freq.mean(0) - p).abs().sum())
        log(f"(f) row {r}: degree {d}, {picks.shape[1]} draws, TVD "
            f"{tvd:.5f} (bound {TVD_BOUND})")
        if not tvd < TVD_BOUND:
            raise AssertionError(f"row {r}: TVD {tvd} >= {TVD_BOUND}")

    # (g) timing at every shape on the main path's slab: the roots at hop
    # 0 (the positives, ScalableSage's and GAT's draws), and the hop-1
    # picks of those roots at hop 1
    n_rows, width = adj["nbr"].shape
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(n_rows, 1))
    hop1 = sampling_kernels.sample_neighbor(adj, roots_c, words, f1)
    timed = []
    for (m, count), nodes, hop in zip(
            B2_SHAPES, (roots_c, hop1.reshape(-1), roots_c, roots_c),
            (0, 1, 0, 0)):
        kern = lambda: sampling_kernels.sample_neighbor(  # noqa: E731
            adj, nodes, words, count, hop=hop)
        plain = lambda: sampling_kernels.sample_neighbor_reference(  # noqa: E731
            adj, nodes, words, count, hop=hop)
        rows = nodes.long()

        def library():  # one torch.multinomial over the gathered rows
            idx = torch.multinomial(probs[rows], count, replacement=True)
            return adj["nbr"][rows].gather(1, idx)

        t = time_draw(kern, plain, library, m, flush)
        b = draw_bound(adj, ((nodes, kern()),), m)
        log(f"(g) sample_neighbor at [{m}, {count}], W={width}: "
            f"{describe(t)}, {describe_bound(b)}")
        timed.append(dict(shape=[m, count], **t, bound_ms=b["bound_ms"],
                          bound_by=b["bound_by"]))
    return dict(max_abs_err=max_err, exact_vs_plain=max_err == 0,
                **{k: v for k, v in timed[0].items() if k != "shape"},
                shapes=timed)


def agree_cpu_cuda(model, graph, seed: int, name: str,
                   lr: float = PPI_LR, inputs=None, host_batch=None,
                   optimizer: str = "adam") -> None:
    """Three steps of ``model`` from the same init on the CPU (plain
    draws) and on the card (kernels), on the same roots (or the model's
    structured ``inputs``) and seeds, or three steps on one host batch
    (``host_batch``, a ``model.sample`` output) uploaded to each, under
    ``optimizer``: first loss rtol 1e-5, all losses rtol 1e-3, step-1
    gradients within 1e-5 of their scale (max |diff| / max(1, max
    |grad|): the unsupervised loss is a sum over the batch, so its
    gradients run to tens)."""
    from euler_tpu_torch import train
    from euler_tpu_torch.models import base

    opt = train.get_optimizer(optimizer, lr)
    st = {d: model.init_state(graph, opt, device=d, seed=seed)
          for d in ("cpu", "cuda")}
    step = model.make_train_step()
    if inputs is None:
        inputs = np.random.default_rng(seed).integers(0, graph.num_nodes, 64)
    losses = {"cpu": [], "cuda": []}
    grads0 = {}
    for i in range(3):
        for d in ("cpu", "cuda"):
            if host_batch is not None:
                batch = base.to_device(host_batch, d)
            else:
                batch = model.device_sample_batch(inputs, seed * 10 + i,
                                                  device=d)
            loss, _ = step(st[d], batch)
            losses[d].append(float(loss))
            if i == 0:
                grads0[d] = [p.grad.cpu()
                             for p in st[d]["module"].parameters()]
    g_err = max(float((a - b).abs().max()) for a, b in
                zip(grads0["cpu"], grads0["cuda"]))
    g_scale = max(1.0, max(float(g.abs().max()) for g in grads0["cpu"]))
    log(f"small {name} losses cpu {losses['cpu']} cuda {losses['cuda']}, "
        f"step-1 max |grad diff| {g_err:.3g} (max |grad| {g_scale:.3g})")
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-5)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-3)
    if not g_err / g_scale < 1e-5:
        raise AssertionError(f"step-1 gradients differ by {g_err} at a "
                             f"scale of {g_scale}")


def table_bytes(consts) -> int:
    """Bytes of every tensor in a (nested) consts dict."""
    if isinstance(consts, dict):
        return sum(table_bytes(v) for v in consts.values())
    if isinstance(consts, (list, tuple)):
        return sum(table_bytes(v) for v in consts)
    return consts.numel() * consts.element_size()


def replay_loss(state, batch: int) -> float:
    """The mean loss of the first chunk's batches under ``state``, without
    a step: ``train.make_scan_train``'s draws for seed 0 (roots from a
    generator seeded 0, step i's draws keyed by i), replayed."""
    from euler_tpu_torch.graph import device as device_graph

    sampler = state["consts"]["roots"]
    gen = torch.Generator(device=sampler["ids"].device).manual_seed(0)
    losses = []
    with torch.no_grad():
        for i in range(CHUNK_STEPS):
            roots = device_graph.sample_node(sampler, batch, generator=gen)
            losses.append(state["module"]({"roots": roots, "seed": i},
                                          state["consts"]).loss)
    return float(torch.stack(losses).mean())


def train_full(model, graph, seed: int, smi: str, name: str,
               edges_per_step, edges_note: str, lr: float = PPI_LR,
               batch: int = PPI_BATCH, pairs_per_step: int = 0,
               fresh_loss_falls: bool = True, scan=None,
               after=None) -> dict:
    """Train ``model`` at full width through ``train.make_scan_train`` (or
    the chunk function ``scan``, for a model whose consts carry no roots
    sampler): a warmup chunk, then TIMED_CHUNKS timed
    chunks. Prints the tables' bytes on the card (and a store model's
    stores'), the peak of allocated device memory, the kernel launches a
    step and, for the walk models, the skip-gram pairs a step and their
    rate. The launch counts are set to 0 just before and read just after;
    returns them and the step ms. Raises unless the losses are finite and
    fall from the first chunk to the last.

    The walk models (``pairs_per_step``) also replay the first chunk's
    batches before and after training (``replay_loss``, outside the
    counted run), and their loss must fall. ``fresh_loss_falls=False``
    keeps only that check: LINE at ``run_loop``'s defaults draws 512 roots
    a step from 56,944 nodes, so in 100 steps a node is a root less than
    once, and the loss of fresh batches need not fall (it rises by about
    0.1% on the CPU, as the JAX package's steps, which the port's
    match).

    ``after(state)``, when given, runs on the trained state after the
    counts are read (``evaluate_held_out``); its result is returned under
    ``"after"``."""
    from euler_tpu_torch import train
    from euler_tpu_torch.graph import sampling_kernels

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = model.init_state(graph, train.get_optimizer("adam", lr),
                             device="cuda", seed=seed)
    torch.cuda.synchronize()
    log(f"{name} state on card in {time.perf_counter() - t0:.2f} s (its tables "
        f"built and uploaded), tables "
        f"{table_bytes(state['consts'])} B, of which adjacency "
        f"{table_bytes(state['consts']['adj'])} B")
    if "stores" in state:
        log(f"{name} stores {[table_bytes(s) for s in state['stores']]} B, "
            f"grad-stores {[table_bytes(s) for s in state['grad_stores']]} "
            f"B")
    scan = scan or train.make_scan_train(model, CHUNK_STEPS, batch)
    replayed = [replay_loss(state, batch)] if pairs_per_step else []
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    state, first = scan(state, 0)  # warmup chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chunk_losses = [first]
    for c in range(1, TIMED_CHUNKS + 1):
        state, losses_c = scan(state, c)
        chunk_losses.append(losses_c)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(sampling_kernels.launches)
    steps = CHUNK_STEPS * (TIMED_CHUNKS + 1)
    all_losses = torch.stack(chunk_losses).cpu()
    log(f"{name} chunk mean losses "
        f"{[round(float(x), 5) for x in all_losses.mean(1)]}")
    if not bool(torch.isfinite(all_losses).all()):
        raise AssertionError(f"{name}: non-finite training loss")
    falls = float(all_losses[-1].mean()) < float(all_losses[0].mean())
    if fresh_loss_falls and not falls:
        raise AssertionError(
            f"{name}: loss did not fall from the first chunk to the last")
    if replayed:
        replayed.append(replay_loss(state, batch))
        log(f"{name} first chunk's batches replayed: mean loss "
            f"{replayed[0]:.5f} at init, {replayed[1]:.5f} after "
            f"{steps} steps; fresh batches' loss fell: {falls}")
        if not replayed[1] < replayed[0]:
            raise AssertionError(f"{name}: the loss of the batches it "
                                 "trained on did not fall")
    step_ms = dt / (CHUNK_STEPS * TIMED_CHUNKS) * 1e3
    runs = {"steps": steps, "launches": launches, "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated()}
    pairs = (f", {pairs_per_step} pairs/step, "
             f"{pairs_per_step / step_ms * 1e3:.1f} pairs/s"
             if pairs_per_step else "")
    per_step = {k: v / steps for k, v in launches.items()}
    log(f"{name} train: {steps} steps, launches {launches} ({per_step} a "
        f"step), step {step_ms:.4f} ms, {edges_per_step} edges/step, "
        f"{edges_per_step / step_ms * 1e3:.1f} edges/s{pairs} "
        f"({edges_note}; timed {CHUNK_STEPS * TIMED_CHUNKS} steps after a "
        f"warmup chunk; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; card: {smi})")
    if after is not None:
        runs["after"] = after(state)
    return runs


def phase_train(graph, hetero, reddit, seed: int, smi: str,
                heavy: "HeavyTailBuild") -> dict:
    """The eighteen main paths; returns {path: {"steps", "launches",
    "step_ms", "peak_bytes"}} (and the held-out evaluation of the
    single-hop and sparse-feature models under "after"). ``heavy`` gives
    reddit_heavytail's graph arrays."""
    log("== phase 4: train")
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import MemoryGraph

    def sage(max_id, dim):
        return mesh_sage(max_id, dim=dim)

    unsup = mesh_unsup  # run_loop --model graphsage's defaults
    small = MemoryGraph(**build_synthetic(2000, 15, 50, 121, seed=seed + 1))
    f1, f2 = PPI_FANOUTS
    runs = {}
    agree_cpu_cuda(sage(small.max_node_id, 32), small, seed, "ppi")
    runs["ppi"] = train_full(
        sage(graph.max_node_id, PPI_DIM), graph, seed, smi, "ppi",
        PPI_BATCH * (f1 + f1 * f2), "512 * (10 + 10*10) sampled edges/step")
    expect = {"sample_fanout2": runs["ppi"]["steps"], "sample_neighbor": 0}
    if runs["ppi"]["launches"] != expect:
        raise AssertionError(f"ppi launches {runs['ppi']['launches']}, "
                             f"expected {expect}")

    agree_cpu_cuda(unsup(small.max_node_id, 32), small, seed, "graphsage")
    # positives (one edge per root) plus the [10, 10] fanouts of roots,
    # positives and negatives: 512 + (512 + 512 + 2,560) * 110
    towers = PPI_BATCH * (2 + SAGE_NEGS)
    runs["graphsage"] = train_full(
        unsup(graph.max_node_id, PPI_DIM), graph, seed, smi, "graphsage",
        PPI_BATCH + towers * (f1 + f1 * f2),
        f"{PPI_BATCH} + {towers} * {f1 + f1 * f2} sampled edges/step")
    steps = runs["graphsage"]["steps"]
    expect = {"sample_fanout2": 3 * steps, "sample_neighbor": steps}
    if runs["graphsage"]["launches"] != expect:
        raise AssertionError(
            f"graphsage launches {runs['graphsage']['launches']}, expected "
            f"{expect}")
    runs.update(train_gcn(graph, small, seed, smi))
    runs.update(train_single_hop(graph, small, seed, smi))
    runs.update(train_sparse(hetero, seed, smi))
    runs.update(train_walks(graph, small, seed, smi))
    reddit_runs, heavy_graph = train_reddit(reddit, seed, smi, heavy)
    runs.update(reddit_runs)
    runs.update(train_heavytail_slab(heavy_graph, heavy, seed, smi))
    runs.update(train_walk_heavytail(heavy_graph, seed, smi))
    return runs


def gcn(max_id: int, dim: int, aggregator: str, batch: int = PPI_BATCH):
    """``run_loop --model gcn --device_sampling``'s model
    (run_loop.py:586-602): metapath [[0], [0]], dim ``dim``, the sparse
    aggregator ``aggregator``, 50 features, 121 labels, sigmoid loss, and
    the caps ``batch * cap**h`` unique nodes a hop with cap =
    max(fanouts) = 10: [5,120, 51,200] at batch 512."""
    from euler_tpu_torch.models import SupervisedGCN

    cap = max(PPI_FANOUTS)
    return SupervisedGCN(
        label_idx=0, label_dim=121, metapath=[[0], [0]], dim=dim,
        max_nodes_per_hop=[batch * cap ** h for h in (1, 2)],
        max_edges_per_hop=[batch * cap ** (h + 1) for h in (0, 1)],
        aggregator=aggregator, feature_idx=1, feature_dim=50, max_id=max_id,
        device_features=True, device_sampling=True)


def scalable_gcn(max_id: int, dim: int):
    """``run_loop --model scalable_gcn --device_sampling``'s model
    (run_loop.py:604-625): 2 layers, dim ``dim``, mean aggregator, slab
    rows capped at max_neighbors = fanouts[0] = 10, store lr 0.001, store
    init 0.05, roots of node type 0."""
    from euler_tpu_torch.models import ScalableGCN

    return ScalableGCN(
        label_idx=0, label_dim=121, edge_type=[0], num_layers=2, dim=dim,
        max_id=max_id, max_neighbors=PPI_FANOUTS[0], aggregator="mean",
        feature_idx=1, feature_dim=50, store_learning_rate=0.001,
        store_init_maxval=0.05, device_features=True, device_sampling=True,
        train_node_type=0)


def sampled_roots_scan(model, sampler, batch: int):
    """``make_scan_train``'s chunk function with ``batch`` roots drawn by
    ``sample_node`` over ``sampler`` each step (the JAX package's
    SupervisedGCN builds no roots sampler of its own) and handed to
    ``model.make_train_step()``."""
    from euler_tpu_torch.graph import device as device_graph

    step = model.make_train_step()

    def scan(state, seed: int):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        losses = []
        for i in range(CHUNK_STEPS):
            roots = device_graph.sample_node(sampler, batch, generator=gen)
            losses.append(step(state, {"roots": roots,
                                       "seed": seed * CHUNK_STEPS + i})[0])
        return state, torch.stack(losses)

    return scan


def first_chunk_roots(sampler, batch: int, chunk: int = 0):
    """The roots of the first (or the ``chunk``-th) chunk's steps:
    ``sample_node`` over ``sampler`` from a generator seeded with the
    chunk's seed, as the chunk loops draw them."""
    from euler_tpu_torch.graph import device as device_graph

    gen = torch.Generator(device="cuda").manual_seed(chunk)
    return [device_graph.sample_node(sampler, batch, generator=gen)
            for _ in range(CHUNK_STEPS)]


def expansion_report(adj, caps, sampler) -> float:
    """Prints one batch's full-neighbor expansion hop by hop (parents,
    their real edges, the unique neighbor ids against the cap, the edges
    the cap keeps) and ``multi_hop_neighbor``'s device time alone; returns
    the real edges a step kept (masks summed over the hops), the mean of
    the first chunk's batches."""
    from euler_tpu_torch.graph import device as device_graph

    roots = first_chunk_roots(sampler, PPI_BATCH)
    default = adj["nbr"].shape[0] - 1
    hops = device_graph.multi_hop_neighbor([adj, adj], roots[0], caps)
    parents = roots[0].long()
    for h, (hop, cap) in enumerate(zip(hops, caps)):
        parents = parents[parents != default]
        width = adj["nbr"].shape[1]
        deg = adj["deg"][parents]
        real = adj["nbr"][parents][torch.arange(width, device="cuda")[None, :]
                                   < deg[:, None]]
        uniq = int(torch.unique(real).numel())
        log(f"gcn expansion hop {h + 1}: {parents.numel()} parents, "
            f"{int(deg.sum())} real edges, {uniq} unique neighbors against a "
            f"cap of {cap} ({max(uniq - cap, 0)} dropped), "
            f"{int(hop['mask'].sum())} edges kept")
        parents = hop["nodes"].long()
    ms = cuda_ms(lambda: device_graph.multi_hop_neighbor(
        [adj, adj], roots[0], caps), runs=50, batch=5)
    edges = statistics.mean(
        float(sum(h["mask"].sum() for h in
                  device_graph.multi_hop_neighbor([adj, adj], r, caps)))
        for r in roots)
    log(f"gcn multi_hop_neighbor alone at [{PPI_BATCH}] roots, caps {caps}: "
        f"{ms:.4f} ms (CUDA events, median of 50); {edges:.1f} real edges "
        f"kept a step (mean of the first chunk's {CHUNK_STEPS} batches)")
    return edges


def train_gcn(graph, small, seed: int, smi: str) -> dict:
    """The GCN family on the ppi graph, each after a CPU/CUDA agreement on
    the small graph: gcn (``run_loop --model gcn`` defaults, mean
    aggregator), gcn_gcnagg (``--aggregator gcn``) and gcn_attention
    (``--aggregator attention``, 4 heads of 64), each a step of roots
    drawn on the card and the full-neighbor expansion; then scalable_gcn
    (``--model scalable_gcn``) through ``make_scan_train``. None launches
    a kernel: the paths are gathers, a sort, cumsums and segment sums."""
    from euler_tpu_torch.graph import device as device_graph

    max_id = graph.max_node_id
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(graph, 0, max_id), "cuda")
    adj = device_graph.tensors(
        device_graph.build_adjacency(graph, [0], max_id), "cuda")
    caps = gcn(max_id, PPI_DIM, "mean").max_nodes_per_hop
    edges = expansion_report(adj, caps, sampler)
    # ScalableGCN's slab rows hold min(degree, max_neighbors) real edges
    row_edges = adj["deg"].clamp(max=PPI_FANOUTS[0])
    sc_edges = statistics.mean(
        float(row_edges[r.long()].sum())
        for r in first_chunk_roots(sampler, PPI_BATCH))
    del adj
    note = (f"real edges kept a step, mean of the first chunk's batches; "
            f"caps {caps}")
    runs = {}
    for name, aggregator in (("gcn", "mean"), ("gcn_gcnagg", "gcn"),
                             ("gcn_attention", "attention")):
        t0 = time.perf_counter()
        agree_cpu_cuda(gcn(small.max_node_id, 32, aggregator, 64), small,
                       seed, name)
        model = gcn(max_id, PPI_DIM, aggregator)
        runs[name] = train_full(
            model, graph, seed, smi, name, edges, note,
            scan=sampled_roots_scan(model, sampler, PPI_BATCH))
        log(f"{name} path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    agree_cpu_cuda(scalable_gcn(small.max_node_id, 32), small, seed,
                   "scalable_gcn")
    runs["scalable_gcn"] = train_full(
        scalable_gcn(max_id, PPI_DIM), graph, seed, smi, "scalable_gcn",
        sc_edges, f"real slab-row edges a step (W = {PPI_FANOUTS[0]}), mean "
        f"of the first chunk's batches")
    log(f"scalable_gcn path: {time.perf_counter() - t0:.1f} s")
    for name, run in runs.items():
        expect = {"sample_fanout2": 0, "sample_neighbor": 0}
        if run["launches"] != expect:
            raise AssertionError(f"{name} launches {run['launches']}, "
                                 f"expected {expect}")
    return runs


def scalable_sage(max_id: int, dim: int):
    """``run_loop --model scalable_sage --device_sampling``'s model
    (run_loop.py:655-671): edge type 0, fanout fanouts[0] = 10, 2 layers
    (len(fanouts)), dim ``dim``, mean aggregator, concat (``--concat``'s
    default), store lr 0.001, store init 0.05, 50 features, 121 labels,
    sigmoid loss, roots of node type 0."""
    from euler_tpu_torch.models import ScalableSage

    return ScalableSage(
        label_idx=0, label_dim=121, edge_type=[0], fanout=SSAGE_FANOUT,
        num_layers=len(PPI_FANOUTS), dim=dim, max_id=max_id,
        aggregator="mean", concat=True, feature_idx=1, feature_dim=50,
        store_learning_rate=0.001, store_init_maxval=0.05,
        device_features=True, device_sampling=True, train_node_type=0)


def gat(max_id: int, dim: int, head_num: int = 1):
    """``run_loop --model gat --device_sampling``'s model
    (run_loop.py:672-688): ``head_num`` heads of hidden width ``dim``
    (``--dim``), nb_num 5, edge type 0, 50 features, 121 labels and
    classes, sigmoid loss, roots of node type 0."""
    from euler_tpu_torch.models import GAT

    return GAT(label_idx=0, label_dim=121, feature_idx=1, feature_dim=50,
               max_id=max_id, head_num=head_num, hidden_dim=dim,
               nb_num=GAT_NB, edge_type=0, device_features=True,
               device_sampling=True, train_node_type=0)


def held_out_roots(sampler, batch: int, n_batches: int, seed: int):
    """``n_batches`` batches of ``batch`` ids of the sampler's node type
    that were never a root in ``train_full``'s run: every chunk's roots
    replayed (``make_scan_train`` seeds chunk c's generator with c) and
    set aside, the rest shuffled by a numpy generator seeded ``seed``."""
    ids = sampler["ids"].long()
    seen = torch.zeros(int(ids.max()) + 1, dtype=torch.bool, device="cuda")
    for c in range(TIMED_CHUNKS + 1):
        for roots in first_chunk_roots(sampler, batch, c):
            seen[roots.long()] = True
    fresh = ids[~seen[ids]].cpu().numpy()
    need = batch * n_batches
    if len(fresh) < need:
        raise AssertionError(f"{len(fresh)} held-out roots, need {need}")
    pick = np.random.default_rng(seed).permutation(fresh)[:need]
    return [pick[i * batch:(i + 1) * batch] for i in range(n_batches)], (
        len(ids) - len(fresh))


def evaluate_held_out(model, graph, seed: int, name: str, batches=None):
    """``after`` for ``train_full``: ``train.evaluate`` over EVAL_BATCHES
    batches of held-out roots (or the given ``batches`` of structured
    inputs); the metric (f1, mrr or auc) must lie in [0, 1] and the loss
    be finite. Returns the result."""
    from euler_tpu_torch import train

    def run(state):
        if batches is None:
            items, n_seen = held_out_roots(state["consts"]["roots"],
                                           PPI_BATCH, EVAL_BATCHES, seed)
            what = (f"{PPI_BATCH} roots, none of the {n_seen} distinct "
                    f"training roots among them")
        else:
            items, what = batches, "fresh structured inputs"
        t0 = time.perf_counter()
        result = train.evaluate(model, graph, items, state, device="cuda",
                                seed=10_000 + seed)
        log(f"{name} evaluate: {result} over {EVAL_BATCHES} batches of "
            f"{what}, in {time.perf_counter() - t0:.2f} s")
        metric = result[model.metric_name]
        if not (0.0 <= metric <= 1.0 and np.isfinite(result["loss"])):
            raise AssertionError(f"{name} evaluate: {result}")
        return result

    return run


def train_single_hop(graph, small, seed: int, smi: str) -> dict:
    """The single-hop models on the ppi graph through
    ``train.make_scan_train``, each after a CPU/CUDA agreement on the
    small graph: scalable_sage (``run_loop --model scalable_sage``
    defaults, B2 once a step at [512, 10]), gat and gat_heads4 (``--model
    gat``, one and four heads, B2 once a step at [512, 5]); B1 never.
    Each then evaluates on held-out roots."""
    max_id = graph.max_node_id
    runs = {}
    for name, make, count in (
            ("scalable_sage", scalable_sage, SSAGE_FANOUT),
            ("gat", gat, GAT_NB),
            ("gat_heads4", lambda m, d: gat(m, d, GAT_HEADS4), GAT_NB)):
        t0 = time.perf_counter()
        agree_cpu_cuda(make(small.max_node_id, 32), small, seed, name)
        model = make(max_id, PPI_DIM)
        runs[name] = train_full(
            model, graph, seed, smi, name, PPI_BATCH * count,
            f"{PPI_BATCH} * {count} sampled edges/step",
            after=evaluate_held_out(model, graph, seed, name))
        expect = {"sample_fanout2": 0, "sample_neighbor": runs[name]["steps"]}
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
        log(f"{name} path: {time.perf_counter() - t0:.1f} s")
    return runs


def lshne(max_id: int, dim: int = LSHNE_DIM):
    """``run_loop --model lshne --device_sampling``'s model
    (run_loop.py:689-700): roots of all node types, one view of two
    [[0], [0], [0]] metapaths, dim 128, hidden 256, a sparse table of
    max_id + 2 rows of 16 over slot 0 (16 ids a row at most), windows
    1/1, 5 typed negatives over 20 types, gamma 5."""
    from euler_tpu_torch.models import LsHNE

    return LsHNE(node_type=-1, path_patterns=LSHNE_PATTERNS, max_id=max_id,
                 dim=dim, sparse_feature_dims=[max_id + 2], feature_ids=[0],
                 num_negs=LSHNE_NEGS, src_type_num=LSHNE_TYPES,
                 device_sampling=True)


def lasgnn(max_id: int, dim: int = PPI_DIM, device_sampling: bool = True):
    """LasGNN at run_loop's widths: ``LASGNN_METAPATHS``, group sizes
    [1, 2], fanouts [10, 10], dim 256, mean aggregation, slot 0 over
    max_id + 1 ids (a table of max_id + 3 rows of 16), 16 ids a row."""
    from euler_tpu_torch.models import LasGNN

    return LasGNN(LASGNN_METAPATHS, list(PPI_FANOUTS), dim, feature_ixs=[0],
                  feature_dims=[max_id + 1], group_sizes=LASGNN_GROUP_SIZES,
                  max_id=max_id, aggregator="mean",
                  device_sampling=device_sampling)


def lasgnn_inputs(sampler, adj, gen, words, batch: int) -> dict:
    """LasGNN's structured inputs for one step, drawn on the card: targets
    from ``sampler``; the first half of the rows positives, their context
    two neighbors of the target over ``adj`` (the plain draw, no kernel),
    label 1; the rest negatives, two sampled nodes, label 0."""
    from euler_tpu_torch.graph import device as device_graph

    roots = device_graph.sample_node(sampler, batch, generator=gen)
    half = batch // 2
    pos = device_graph.sample_neighbor(adj, roots[:half], 2, words)
    neg = device_graph.sample_node(sampler, 2 * (batch - half),
                                   generator=gen).reshape(-1, 2)
    label = torch.cat([torch.ones(half, device="cuda"),
                       torch.zeros(batch - half, device="cuda")])
    return {"label": label[:, None],
            "groups": [roots[:, None], torch.cat([pos, neg])]}


def lasgnn_scan(model, sampler, adj, batch: int):
    """The chunk function of ``train_full`` for LasGNN, whose inputs are
    structured: each step's inputs from ``lasgnn_inputs`` (generator
    seeded with the chunk's seed), through ``model.make_train_step()``."""
    from euler_tpu_torch.graph import device as device_graph

    step = model.make_train_step()

    def scan(state, seed: int):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        losses = []
        for i in range(CHUNK_STEPS):
            s = seed * CHUNK_STEPS + i
            inputs = lasgnn_inputs(sampler, adj, gen,
                                   device_graph.stream_words(s, 1 << 16),
                                   batch)
            losses.append(step(state, model.device_sample_batch(
                inputs, s, device="cuda"))[0])
        return state, torch.stack(losses)

    return scan


def train_sparse(hetero, seed: int, smi: str) -> dict:
    """The sparse-feature models on the heterogeneous ppi variant, each
    after a CPU/CUDA agreement on a 2,000-node variant: lshne through
    ``train.make_scan_train`` (B2 six times a step at [512, 1], B1 never;
    peak allocated memory under 2 GB, which a weight matrix a tower row
    alone would pass), then lasgnn through ``make_train_step`` on inputs
    drawn on the card (B1 three times a step, B2 never). Each then runs
    ``train.evaluate`` over 10 batches."""
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import MemoryGraph
    from euler_tpu_torch.graph import device as device_graph

    max_id = hetero.max_node_id
    small = MemoryGraph(**hetero_variant(build_synthetic(2000, 15, 50, 121,
                                                   seed=seed + 1), seed + 4))
    runs = {}
    t0 = time.perf_counter()
    agree_cpu_cuda(lshne(small.max_node_id, 32), small, seed, "lshne")
    model = lshne(max_id)
    walk_edges = PPI_BATCH * 2 * 3
    runs["lshne"] = train_full(
        model, hetero, seed, smi, "lshne", walk_edges,
        f"{PPI_BATCH} roots x 2 walks of 3 edges; {LSHNE_PAIRS} pairs and "
        f"{LSHNE_PAIRS * LSHNE_NEGS} typed negatives a step",
        pairs_per_step=LSHNE_PAIRS,
        after=evaluate_held_out(model, hetero, seed, "lshne"))
    if runs["lshne"]["peak_bytes"] >= 2e9:
        raise AssertionError(f"lshne peak {runs['lshne']['peak_bytes']} B")
    log(f"lshne path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n = small.num_nodes
    agree_cpu_cuda(lasgnn(small.max_node_id, 32), small, seed, "lasgnn",
                   inputs={"label": rng.integers(0, 2, (64, 1)),
                           "groups": [rng.integers(0, n, (64, 1)),
                                      rng.integers(0, n, (64, 2))]})
    model = lasgnn(max_id)
    sampler = device_graph.tensors(
        device_graph.build_node_sampler(hetero, -1, max_id), "cuda")
    adj = device_graph.tensors(
        device_graph.build_adjacency(hetero, [0, 1], max_id), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(10_000 + seed)
    held_out = [lasgnn_inputs(sampler, adj, gen,
                              device_graph.stream_words(10_000 + i, 1 << 16),
                              PPI_BATCH) for i in range(EVAL_BATCHES)]
    f1, f2 = PPI_FANOUTS
    # one fanout a (group, metapath): 512 targets once, 1,024 context
    # nodes twice
    roots = sum(PPI_BATCH * n * len(m)
                for n, m in zip(LASGNN_GROUP_SIZES, LASGNN_METAPATHS))
    runs["lasgnn"] = train_full(
        model, hetero, seed, smi, "lasgnn", roots * (f1 + f1 * f2),
        f"{roots} fanout roots (the 512 targets once, the 1,024 context "
        f"nodes once a metapath) * ({f1} + {f1}*{f2}) sampled edges/step",
        scan=lasgnn_scan(model, sampler, adj, PPI_BATCH),
        after=evaluate_held_out(model, hetero, seed, "lasgnn", held_out))
    log(f"lasgnn path: {time.perf_counter() - t0:.1f} s")
    steps = runs["lshne"]["steps"]
    for name, expect in (
            ("lshne", {"sample_fanout2": 0, "sample_neighbor": 6 * steps}),
            ("lasgnn", {"sample_fanout2": 3 * steps, "sample_neighbor": 0})):
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
    return runs


def node2vec(max_id: int, dim: int, p: float = 1.0, q: float = 1.0,
             alias: bool = False):
    """``run_loop --model node2vec --device_sampling``'s model: all node
    types, the graph's one edge type, dim ``dim``, id embeddings of
    max_id+2 rows (combiner add), walk_len 5, windows 5/5, 5 negatives,
    sigmoid cross-entropy; over sorted alias tables when ``alias``."""
    from euler_tpu_torch.models import Node2Vec

    model = Node2Vec(
        node_type=-1, edge_type=[0], max_id=max_id, dim=dim,
        walk_len=N2V_WALK_LEN, walk_p=p, walk_q=q, left_win_size=N2V_WINDOW,
        right_win_size=N2V_WINDOW, num_negs=SAGE_NEGS, xent_loss=True,
        device_sampling=True)
    if model.batch_size_ratio * PPI_BATCH != N2V_ROOTS:
        raise AssertionError(f"node2vec pairs a root: "
                             f"{model.batch_size_ratio}, expected 30")
    if alias:
        model.set_sampling_options(alias=True)
    return model


def line(max_id: int, dim: int):
    """``run_loop --model line``'s model: order 1, dim ``dim``, 5
    negatives, sigmoid cross-entropy, id embeddings."""
    from euler_tpu_torch.models import LINE

    return LINE(node_type=-1, edge_type=[0], max_id=max_id, dim=dim,
                order=1, num_negs=SAGE_NEGS, xent_loss=True,
                device_sampling=True)


def train_walks(graph, small, seed: int, smi: str) -> dict:
    """The walk models on the ppi graph, each after a CPU/CUDA agreement
    on the small graph where it has one: node2vec (five B2 launches a
    step, at [15,360, 1]), node2vec_biased (the sorted slab, no kernel)
    and line (one B2 launch a step, at [512, 1])."""
    max_id = graph.max_node_id
    edges = N2V_ROOTS * N2V_WALK_LEN
    pairs = N2V_ROOTS * 30
    note = f"{N2V_ROOTS} walks of {N2V_WALK_LEN} edges, 30 pairs a root"
    runs = {}
    agree_cpu_cuda(node2vec(small.max_node_id, 32), small, seed, "node2vec")
    runs["node2vec"] = train_full(
        node2vec(max_id, PPI_DIM), graph, seed, smi, "node2vec", edges, note,
        batch=N2V_ROOTS, pairs_per_step=pairs)
    runs["node2vec_biased"] = train_full(
        node2vec(max_id, PPI_DIM, *BIASED_PQ[0]), graph, seed, smi,
        "node2vec_biased", edges, note, batch=N2V_ROOTS,
        pairs_per_step=pairs)
    agree_cpu_cuda(line(small.max_node_id, 32), small, seed, "line")
    runs["line"] = train_full(
        line(max_id, PPI_DIM), graph, seed, smi, "line", PPI_BATCH,
        f"{PPI_BATCH} positive edges", pairs_per_step=PPI_BATCH,
        fresh_loss_falls=False)
    for name, b2 in (("node2vec", N2V_WALK_LEN), ("node2vec_biased", 0),
                     ("line", 1)):
        steps = runs[name]["steps"]
        expect = {"sample_fanout2": 0, "sample_neighbor": b2 * steps}
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
    return runs


def train_walk_heavytail(graph, seed: int, smi: str) -> dict:
    """node2vec_biased's recipe on the heavy-tail graph that
    reddit_heavytail trained on (not built again), over its sorted alias
    tables: the exact rejection walk, 64 trials a step and 16-step
    bisection, no kernel."""
    t0 = time.perf_counter()
    run = train_full(
        node2vec(graph.max_node_id, PPI_DIM, *BIASED_PQ[0], alias=True),
        graph, seed, smi, "node2vec_heavytail", N2V_ROOTS * N2V_WALK_LEN,
        f"{N2V_ROOTS} walks of {N2V_WALK_LEN} edges, 30 pairs a root",
        batch=N2V_ROOTS, pairs_per_step=N2V_ROOTS * 30)
    expect = {"sample_fanout2": 0, "sample_neighbor": 0}
    if run["launches"] != expect:
        raise AssertionError(f"node2vec_heavytail launches "
                             f"{run['launches']}, expected {expect}")
    log(f"node2vec_heavytail path: {time.perf_counter() - t0:.1f} s")
    return {"node2vec_heavytail": run}


def reddit_sage(max_id: int, feature_dtype=None, alias: bool = False):
    """``bench.py``'s reddit model (bench.py:608-625): batch 1,000,
    fanouts [4, 4], dim 64, 602 features, 41 one-hot labels, mean
    aggregator, the default sigmoid loss."""
    from euler_tpu_torch.datasets import REDDIT
    from euler_tpu_torch.models import SupervisedGraphSage

    model = SupervisedGraphSage(
        label_idx=0, label_dim=REDDIT["label_dim"], metapath=[[0], [0]],
        fanouts=list(REDDIT_FANOUTS), dim=REDDIT_DIM, feature_idx=1,
        feature_dim=REDDIT["feature_dim"], max_id=max_id,
        device_features=True, device_sampling=True,
        feature_dtype=feature_dtype)
    if alias:
        model.set_sampling_options(alias=True)
    return model


class ChildData:
    """Data that a child process makes while the card works on earlier
    phases, in a scratch directory of its own (``workdir``): ``code`` runs
    from the checkout with ``workdir`` and ``args`` as its arguments and
    prints one JSON line last, which ``result()`` waits for (up to
    ``timeout`` seconds)."""

    def __init__(self, name: str, code: str, *args,
                 timeout: float = 900.0):
        root = os.path.dirname(os.path.abspath(__file__))
        self.name = name
        self.timeout = timeout
        self._dir = scratch_dir()
        self.workdir = self._dir.name
        self._log = open(os.path.join(self.workdir, "child.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code, self.workdir, *map(str, args)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=self._log, stderr=subprocess.STDOUT)

    def result(self) -> dict:
        """The child's JSON line, once it has exited 0."""
        rc = self.proc.wait(timeout=self.timeout)
        self._log.seek(0)
        out = self._log.read()
        if rc != 0:
            raise AssertionError(f"{self.name} exited {rc}:\n{out[-3000:]}")
        return json_line(out)

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._log.close()
        self._dir.cleanup()


class HeavyTailBuild(ChildData):
    """reddit_heavytail's graph arrays, ``build_powerlaw(
    **REDDIT_HEAVYTAIL)`` (113.7M edges: a minute or more of host work),
    and its slab at ``max_degree=HEAVY_SLAB_DEGREE`` (7.63 GB at 4,096),
    built by a child process from the start of phase 3 on, so that the
    builds overlap phase 3's spins on the card; ``arrays()`` waits for
    them and loads the graph here, ``slab()`` the slab."""

    def __init__(self):
        from euler_tpu_torch.datasets import REDDIT_HEAVYTAIL

        code = ("import json, os, sys, time, warnings\n"
                "import numpy as np\n"
                "from euler_tpu_torch.datasets import build_powerlaw\n"
                "from euler_tpu_torch.graph import MemoryGraph\n"
                "from euler_tpu_torch.graph import device\n"
                "t0 = time.perf_counter()\n"
                "d = build_powerlaw(**json.loads(sys.argv[2]))\n"
                "t1 = time.perf_counter()\n"
                "feats = d.pop('dense_features')\n"
                "np.savez(os.path.join(sys.argv[1], 'heavytail.npz'), "
                "dense_0=feats[0], dense_1=feats[1], **d)\n"
                "t2 = time.perf_counter()\n"
                "del feats\n"
                "g = MemoryGraph(**d)\n"
                "with warnings.catch_warnings():\n"
                "    warnings.simplefilter('ignore')\n"
                "    slab = device.build_adjacency(g, [0], "
                "len(d['node_weights']) - 1, max_degree=int(sys.argv[3]))\n"
                "t3 = time.perf_counter()\n"
                "deg = np.diff(d['indptr'])\n"
                "info = {'truncated': int((deg > slab['nbr'].shape[1]).sum()),"
                " 'kept': int(slab['deg'].sum()), 'edges': int(deg.sum())}\n"
                "del g, d\n"
                "for k, v in slab.items():\n"
                "    np.save(os.path.join(sys.argv[1], 'slab_' + k + "
                "'.npy'), v)\n"
                "print(json.dumps({'build_s': t1 - t0, 'save_s': t2 - t1, "
                "'slab_s': t3 - t2, 'slab_save_s': time.perf_counter() - t3,"
                " **info}))\n")
        super().__init__("the heavy-tail build", code,
                         json.dumps(REDDIT_HEAVYTAIL), HEAVY_SLAB_DEGREE,
                         timeout=1200.0)
        self.path = os.path.join(self.workdir, "heavytail.npz")

    def slab(self) -> tuple:
        """``(the slab's arrays, the child's JSON line, load s)``, after
        ``arrays()``."""
        t0 = time.perf_counter()
        slab = {k: np.load(os.path.join(self.workdir, f"slab_{k}.npy"))
                for k in ("nbr", "cum", "deg", "sampleable")}
        for k in slab:
            os.unlink(os.path.join(self.workdir, f"slab_{k}.npy"))
        return slab, self.result(), time.perf_counter() - t0

    def arrays(self) -> tuple:
        """``(MemoryGraph arrays, build s, save s, load s)``."""
        times = self.result()
        t0 = time.perf_counter()
        with np.load(self.path) as z:
            data = {k: z[k] for k in z.files}
        data["dense_features"] = [data.pop("dense_0"), data.pop("dense_1")]
        os.unlink(self.path)
        return (data, times["build_s"], times["save_s"],
                time.perf_counter() - t0)


def train_reddit(reddit, seed: int, smi: str, heavy: HeavyTailBuild):
    """bench.py's reddit, reddit_bf16 and reddit_heavytail configs, each
    after a CPU/CUDA agreement on a small graph: B1 once per step on the
    synthetic graph's slab (float32 and bfloat16 feature tables), no
    kernel on the heavy-tail graph's alias tables (its arrays from
    ``heavy``). Returns the runs and the heavy-tail graph."""
    from euler_tpu_torch.datasets import (REDDIT, build_powerlaw,
                                          build_synthetic)
    from euler_tpu_torch.graph import MemoryGraph

    graph, build_s = reddit
    f1, f2 = REDDIT_FANOUTS
    edges = REDDIT_BATCH * (f1 + f1 * f2)
    note = f"{REDDIT_BATCH} * ({f1} + {f1}*{f2}) sampled edges/step"
    width = dict(feature_dim=REDDIT["feature_dim"],
                 label_dim=REDDIT["label_dim"])
    small = MemoryGraph(**build_synthetic(2000, REDDIT["avg_degree"], **width,
                                    multilabel=False, seed=seed + 2))
    small_pl = MemoryGraph(**build_powerlaw(3000, 90_000, **width, seed=seed + 3))
    runs = {}
    for name, feature_dtype, alias in (("reddit", None, False),
                                       ("reddit_bf16", "bfloat16", False),
                                       ("reddit_heavytail", None, True)):
        t_path = time.perf_counter()
        if alias:
            t0 = time.perf_counter()
            data, build_s, save_s, load_s = heavy.arrays()
            t1 = time.perf_counter()
            graph = MemoryGraph(**data)
            t2 = time.perf_counter()
            log(f"{name} graph {graph.num_nodes} nodes, "
                f"{len(data['indices'])} edges (REDDIT_HEAVYTAIL, no cut), "
                f"max degree {np.diff(data['indptr']).max()}, built in "
                f"{build_s + t2 - t1:.2f} s ({build_s:.2f} s build_powerlaw "
                f"in a child process from phase 3 on, saved in {save_s:.2f}"
                f" s, waited for {t1 - t0 - load_s:.2f} s and loaded in "
                f"{load_s:.2f} s here; {t2 - t1:.2f} s MemoryGraph with its "
                f"sort); its alias tables are built in init_state")
            del data
        else:
            log(f"{name} graph: the synthetic reddit graph of phase 3 (j), "
                f"built in {build_s:.2f} s")
        g_small = small_pl if alias else small
        agree_cpu_cuda(reddit_sage(g_small.max_node_id, feature_dtype, alias),
                       g_small, seed, name, REDDIT_LR)
        runs[name] = train_full(
            reddit_sage(graph.max_node_id, feature_dtype, alias), graph,
            seed, smi, name, edges, note, REDDIT_LR, REDDIT_BATCH)
        steps = runs[name]["steps"]
        expect = {"sample_fanout2": 0 if alias else steps,
                  "sample_neighbor": 0}
        if runs[name]["launches"] != expect:
            raise AssertionError(f"{name} launches {runs[name]['launches']}, "
                                 f"expected {expect}")
        log(f"{name} path: {time.perf_counter() - t_path:.1f} s")
    return runs, graph


def train_heavytail_slab(graph, heavy: HeavyTailBuild, seed: int,
                         smi: str) -> dict:
    """reddit_heavytail_slab: bench.py's reddit recipe on reddit_heavytail's
    graph (``graph``) over its slab at ``max_degree=HEAVY_SLAB_DEGREE``,
    built by ``heavy``'s child: B1 once a step on the wide path, after a
    CPU/CUDA agreement on a power-law graph whose widest rows pass 1,024.
    The entry's own slab build is skipped on this path: the model's
    ``add_sampling_consts`` is wrapped to put the child's slab, built by
    the same ``build_adjacency`` call (edge type 0, the graph's max id,
    the same cap), under its key first, and ``add_sampling_consts`` keeps
    an adjacency it is handed, so ``init_state`` builds only the rest.
    That moves the slab's 34-41 s of host work into the child, where it
    overlaps phases 3 and 4 instead of adding to the script's time; the
    in-process build at this cap on this graph is not run on the card."""
    from euler_tpu_torch.datasets import REDDIT, build_powerlaw
    from euler_tpu_torch.graph import MemoryGraph
    from euler_tpu_torch.graph import device as device_graph

    name = "reddit_heavytail_slab"
    t_path = time.perf_counter()
    slab, info, load_s = heavy.slab()
    width = slab["nbr"].shape[1]
    log(f"{name}: slab {tuple(slab['nbr'].shape)} at max_degree "
        f"{HEAVY_SLAB_DEGREE} built by the child in {info['slab_s']:.2f} s "
        f"(saved in {info['slab_save_s']:.2f} s, loaded here in "
        f"{load_s:.2f} s): {sum(v.nbytes for v in slab.values())} B, "
        f"{info['truncated']} rows truncated, {info['kept']} of "
        f"{info['edges']} edges kept ({info['kept'] / info['edges']:.4f}; "
        f"card: {smi})")
    t0 = time.perf_counter()
    adj = device_graph.tensors(slab, "cuda")
    torch.cuda.synchronize()
    del slab
    log(f"{name}: slab on the card in {time.perf_counter() - t0:.2f} s")

    def with_slab(model):
        model.set_sampling_options(max_degree=HEAVY_SLAB_DEGREE)
        add = model.add_sampling_consts

        def add_sampling_consts(consts, *args, **kwargs):
            consts.setdefault("adj", {})[model.adj_key([0])] = adj
            return add(consts, *args, **kwargs)
        model.add_sampling_consts = add_sampling_consts
        return model

    data = build_powerlaw(*WIDE_SMALL_GRAPH,
                          feature_dim=REDDIT["feature_dim"],
                          label_dim=REDDIT["label_dim"], seed=seed + 4)
    small_width = int(np.diff(data["indptr"]).max())
    small = MemoryGraph(**data)
    if not small_width > 1024:
        raise AssertionError(f"{name}: the agreement graph's widest row "
                             f"{small_width} does not pass 1,024")
    agree_cpu_cuda(reddit_sage(small.max_node_id), small, seed, name,
                   REDDIT_LR)
    log(f"{name}: CPU/CUDA agreement on a power-law graph of "
        f"{small.num_nodes} nodes, widest row {small_width} (B1 on the wide "
        "path)")
    f1, f2 = REDDIT_FANOUTS
    run = train_full(
        with_slab(reddit_sage(graph.max_node_id)), graph, seed, smi, name,
        REDDIT_BATCH * (f1 + f1 * f2),
        f"{REDDIT_BATCH} * ({f1} + {f1}*{f2}) sampled edges/step, W={width}",
        REDDIT_LR, REDDIT_BATCH)
    expect = {"sample_fanout2": run["steps"], "sample_neighbor": 0}
    if run["launches"] != expect:
        raise AssertionError(f"{name} launches {run['launches']}, expected "
                             f"{expect}")
    log(f"{name} path: {time.perf_counter() - t_path:.1f} s")
    return {name: run}


class _LogLines(logging.Handler):
    """The run_loop's log lines, kept for parsing."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


_STEP_LINE = re.compile(
    r"step=(\d+) loss=(\S+) \S+=\S+ steps/s=(\S+) input_stall_ms=(\S+) "
    r"stalled=(\d+)/\d+ sample_ms=(\S+)")


def run_loop_main(argv, device: str) -> list:
    """``run_loop.main(argv)`` on ``device``; returns its per-window
    ``(step, loss, step_ms, input_stall_ms, stalled, sample_ms)``."""
    from euler_tpu_torch import run_loop

    lines = _LogLines()
    logger = logging.getLogger("euler_tpu_torch")
    logger.addHandler(lines)
    try:
        if run_loop.main(argv, device=device) != 0:
            raise AssertionError(f"run_loop.main({argv}) failed")
    finally:
        logger.removeHandler(lines)
    out = []
    for line in lines.lines:
        m = _STEP_LINE.search(line)
        if m:
            step, loss, sps, stall, stalled, sample = m.groups()
            out.append((int(step), float(loss), 1e3 / float(sps),
                        float(stall), int(stalled), float(sample)))
    return out


def device_busy_us(prof) -> float:
    """Device microseconds of a profile: device-side events only, no user
    annotations (as scripts/torch_step_profile.py counts them)."""
    from torch.autograd import DeviceType

    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation)


def run_loop_path(name: str, data_dir: str, model_dir: str, extra,
                  seed: int, smi: str, device: str, max_id: int) -> dict:
    """One run_loop path: train one epoch, evaluate, save_embedding, with
    the launch counts set to 0 just before training and read just after.
    Checks the loss (finite, falling), the checkpoint's latest step,
    eval.json's f1 and that embedding.npy is ``train.save_embedding`` of
    the restored state. Returns the launches, the steps' numbers and the
    trained state (captured from ``train.train``)."""
    from euler_tpu_torch import heat, run_loop
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.graph import native, sampling_kernels

    argv = ["--data_dir", data_dir, "--model_dir", model_dir,
            "--max_id", str(max_id), "--seed", str(seed), *RUN_LOOP_ARGS,
            *extra]
    steps = (max_id + 1) // PPI_BATCH
    trained = {}
    real_train = train_lib.train

    def keep_state(*a, **k):  # the trained state, for phase (g)
        trained["state"], history = real_train(*a, **k)
        return trained["state"], history

    torch.cuda.reset_peak_memory_stats()
    native.reset_counters()
    heat.heat_reset()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    train_lib.train = keep_state
    try:
        t0 = time.perf_counter()
        windows = run_loop_main(argv, device)
        wall = time.perf_counter() - t0
    finally:
        train_lib.train = real_train
    launches = dict(sampling_kernels.launches)
    # the transport's ledger and the client's fan-out of the training
    # run (this process's side; a remote graph's shards keep their own)
    wire = {"counters": native.counters(), "fanout": heat.heat_json()[
        "fanout"]}
    peak = torch.cuda.max_memory_allocated()
    losses = np.array([w[1] for w in windows])
    if len(windows) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: {len(windows)} logged steps of "
                             f"{steps}, losses {losses}")
    head, tail = losses[:10].mean(), losses[-10:].mean()
    if not tail < head:
        raise AssertionError(f"{name}: loss did not fall ({head} -> {tail})")
    latest = Checkpointer(model_dir).latest_step()
    if latest != steps:
        raise AssertionError(f"{name}: latest checkpoint {latest}, "
                             f"expected {steps}")
    step_ms = statistics.median(w[2] for w in windows[10:])
    stall_ms = float(np.mean([w[3] for w in windows[10:]]))
    stalled = sum(w[4] for w in windows)
    sample_ms = float(np.mean([w[5] for w in windows]))
    edges = PPI_BATCH * (PPI_FANOUTS[0] + PPI_FANOUTS[0] * PPI_FANOUTS[1])
    log(f"{name} train: run_loop.main {wall:.2f} s, {steps} steps, launches "
        f"{launches}, loss {head:.5f} (first 10) -> {tail:.5f} (last 10), "
        f"step {step_ms:.4f} ms (median of steps 11-{steps}, each step "
        f"synced by --log_steps 1), {edges} edges/step, "
        f"{edges / step_ms * 1e3:.1f} edges/s, batch build "
        f"{sample_ms:.4f} ms in a prefetch worker, input stall "
        f"{stall_ms:.4f} ms a step, {stalled} of {steps} steps waited over "
        f"1 ms on prefetch, max_memory_allocated {peak} B, latest "
        f"checkpoint {latest} (card: {smi})")
    after = dict(sampling_kernels.launches)
    t0 = time.perf_counter()
    run_loop_main(argv + ["--mode", "evaluate"], device)
    with open(os.path.join(model_dir, "eval.json")) as f:
        result = json.load(f)
    if not 0.0 <= result["f1"] <= 1.0:
        raise AssertionError(f"{name}: eval f1 {result['f1']}")
    run_loop_main(argv + ["--mode", "save_embedding"], device)
    emb = np.load(os.path.join(model_dir, "embedding.npy"))
    args = run_loop.define_flags().parse_args(
        argv + ["--mode", "save_embedding"])
    graph, services = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    restored = run_loop._restore_state(model, graph, args, device)
    want = train_lib.save_embedding(model, max_id, restored,
                                    batch_size=PPI_BATCH, device=device,
                                    graph=graph)
    if emb.shape != (max_id + 1, PPI_DIM) or not np.isfinite(emb).all():
        raise AssertionError(f"{name}: embedding.npy {emb.shape}")
    def row_cosine(a, b):
        return (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)

    cos = row_cosine(emb, want)
    # the same rows against other nodes' rows: what no relation scores
    cos_other = row_cosine(emb, np.roll(want, 1, axis=0))
    if model.device_sampling:
        # the draws are keyed by the embed batches' seeds: bit-equal
        same = bool(np.array_equal(emb, want))
    else:
        # the engine's OpenMP threads draw from their own RNG streams,
        # which --seed does not reach: the same model over fresh samples
        same = np.median(cos) > np.median(cos_other) + EXPORT_COSINE_MARGIN
    if not same:
        raise AssertionError(f"{name}: embedding.npy is not "
                             "train.save_embedding of the restored state "
                             f"(median row cosine {np.median(cos)})")
    log(f"{name} evaluate and save_embedding: {time.perf_counter() - t0:.2f}"
        f" s, eval {result}, embedding.npy {emb.shape} against "
        f"train.save_embedding of the restored state: "
        f"{'bit-equal' if model.device_sampling else 'resampled'}, row "
        f"cosine median {np.median(cos):.6f} min {cos.min():.6f} (against "
        f"the next node's row: median {np.median(cos_other):.6f}); tables "
        f"{table_bytes(restored['consts'])} B; launches while evaluating "
        f"and exporting {dict((k, sampling_kernels.launches[k] - after[k]) for k in after)}")
    graph.close()
    run_loop.stop_services(services)
    return {"launches": launches, "steps": steps, "step_ms": step_ms,
            "peak_bytes": peak, "state": trained["state"],
            "restored": restored, "model": model, "wire": wire,
            "losses": losses, "eval": result, "stall_ms": stall_ms,
            "stalled": stalled, "sample_ms": sample_ms}


def profile_host_steps(model, graph, source_fn, seed: int, device: str,
                       lr: float = PPI_LR) -> str:
    """21 steps of ``train.train`` over a host-sampling model (fresh
    state), one ``torch.profiler`` window over steps 11-20: the wall and
    device ms a step, the busy share, the batch build ms in a worker and
    the input stall, as a line."""
    from torch.profiler import ProfilerActivity, profile

    from euler_tpu_torch import train

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    prof = profile(activities=acts)
    window = {}

    def hook(step):
        if step == 10:
            torch.cuda.synchronize()
            prof.start()
            window["t0"] = time.perf_counter()
        elif step == 20:
            torch.cuda.synchronize()
            window["wall"] = time.perf_counter() - window["t0"]
            prof.stop()

    _, history = train.train(
        model, graph, source_fn, num_steps=21, learning_rate=lr,
        log_every=1, seed=seed, device=device, step_hook=hook,
        log_fn=lambda msg: None)
    busy = device_busy_us(prof) / 1e6
    return (f"wall {window['wall'] / 10 * 1e3:.4f} ms/step, device busy "
            f"{busy / 10 * 1e3:.4f} ms/step, busy share "
            f"{busy / window['wall']:.4f}; batch build "
            f"{np.mean([h['sample_ms'] for h in history[10:20]]):.4f} ms, "
            f"input stall "
            f"{np.mean([h['input_stall_ms'] for h in history[10:20]]):.4f}"
            f" ms a step")


def scratch_dir():
    """A temporary directory under the checkout's ``build/``, removed on
    exit."""
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(work, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=work)


def phase_engine(seed: int, smi: str, device: str = "cuda",
                 ppi: dict | None = None, workdir: str | None = None) -> dict:
    """The engine client and run_loop on the full synthetic ppi graph:
    (a) the engine's build (phase 2), (b) ``datasets.build_ppi`` writes
    the .dat files, (c) ``Graph(directory=...)`` loads them, (d) the
    device tables from the engine equal those from ``MemoryGraph`` over
    the same seed's arrays, on the card, (e) ``run_loop`` trains
    graphsage_supervised with --device_sampling 1 (B1 once a step), then
    evaluates and exports embeddings, (f) the same with host sampling (no
    kernel launch), plus one torch.profiler window of 10 host-sampled
    steps of ``train.train``, (g) the device run's checkpoint restored
    into a fresh model gives its trained state's forward bit for bit.
    The .dat files and checkpoints go under ``workdir`` (``ppi``, ``m1``
    for the device run, ``m2`` for the host run), a scratch directory
    under ``build/`` when none is given."""
    log("== phase 5: engine and run_loop")
    from euler_tpu_torch import datasets
    from euler_tpu_torch.graph import Graph, MemoryGraph, sampling_kernels
    from euler_tpu_torch.models import SupervisedGraphSage

    ppi = ppi or datasets.PPI
    max_id = ppi["num_nodes"] - 1
    runs = {}
    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(scratch_dir())
        data_dir = os.path.join(tmp, "ppi")
        t0 = time.perf_counter()
        datasets.build_ppi(data_dir, **ppi)
        t1 = time.perf_counter()
        nbytes = sum(os.path.getsize(os.path.join(data_dir, n))
                     for n in os.listdir(data_dir))
        graph = Graph(directory=data_dir)
        t2 = time.perf_counter()
        nbrs = int(graph.get_full_neighbor(np.arange(max_id + 1), [0])[3]
                   .sum())
        log(f"(b) build_ppi wrote {sorted(os.listdir(data_dir))}, {nbytes} "
            f"B in {t1 - t0:.2f} s; (c) Graph(directory=...) loaded "
            f"{graph.num_nodes} nodes, {graph.num_edges} edges ({nbrs} "
            f"neighbor entries; the files carry no edge records) in "
            f"{t2 - t1:.2f} s (card: {smi})")
        mem = MemoryGraph(**datasets.build_synthetic(**ppi))
        model = SupervisedGraphSage(
            label_idx=0, label_dim=ppi["label_dim"], metapath=[[0], [0]],
            fanouts=list(PPI_FANOUTS), dim=PPI_DIM, feature_idx=1,
            feature_dim=ppi["feature_dim"], max_id=max_id,
            device_features=True, device_sampling=True)
        t0 = time.perf_counter()
        tables = [model.build_consts(g, device) for g in (graph, mem)]
        flat = [[], []]
        for i, c in enumerate(tables):
            stack = [c]
            while stack:
                x = stack.pop()
                if isinstance(x, dict):
                    stack += [x[k] for k in sorted(x, reverse=True)]
                else:
                    flat[i].append(x)
        if len(flat[0]) != len(flat[1]) or not all(
                a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(*flat)):
            raise AssertionError("device tables from the engine differ from "
                                 "those from MemoryGraph")
        log(f"(d) slab, root sampler, feature and label tables from the "
            f"engine and from MemoryGraph: bit-equal on {device} "
            f"({len(flat[0])} tensors, {table_bytes(tables[0])} B; both "
            f"built in {time.perf_counter() - t0:.2f} s)")
        del tables, flat, mem
        graph.close()

        dev_run = run_loop_path("run_loop_device", data_dir,
                                os.path.join(tmp, "m1"),
                                ["--device_sampling", "1"], seed, smi,
                                device, max_id)
        if dev_run["launches"] != {"sample_fanout2": dev_run["steps"],
                                   "sample_neighbor": 0}:
            raise AssertionError(f"run_loop_device launches "
                                 f"{dev_run['launches']}")
        host_run = run_loop_path("run_loop_host", data_dir,
                                 os.path.join(tmp, "m2"), [], seed, smi,
                                 device, max_id)
        moved = {k: v for k, v in sampling_kernels.launches.items() if v}
        if host_run["launches"] != {"sample_fanout2": 0,
                                    "sample_neighbor": 0} or moved:
            raise AssertionError(f"run_loop_host launched {moved}")

        # (f) one profiler window of 10 host-sampled steps
        graph = Graph(directory=data_dir)
        log("(f) host-sampled train.train profiled over steps 11-20: "
            + profile_host_steps(
                host_run["model"], graph,
                lambda step: graph.sample_node(PPI_BATCH, 0), seed, device)
            + f" (card: {smi})")
        graph.close()

        # (g) restore round trip
        fixed = np.random.default_rng(seed).integers(0, max_id + 1,
                                                      PPI_BATCH)
        m = dev_run["model"]
        outs = []
        for st in (dev_run["state"], dev_run["restored"]):
            with torch.no_grad():
                out = st["module"](m.device_sample_batch(fixed, 99, device),
                                   st["consts"])
            outs.append((out.embedding, out.loss))
        if not (torch.equal(outs[0][0], outs[1][0])
                and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError("the restored checkpoint's forward differs "
                                 "from the trained state's")
        log(f"(g) m1 restored into a fresh model: forward on {PPI_BATCH} "
            f"fixed roots bit-equal to the trained state's (loss "
            f"{float(outs[0][1]):.6f})")
    for name, r in (("run_loop_device", dev_run), ("run_loop_host",
                                                   host_run)):
        runs[name] = {k: r[k] for k in ("launches", "steps", "step_ms",
                                        "peak_bytes")}
    return runs


def cli_wide(work: str, seed: int, smi: str) -> dict:
    """Phase 5 (h): ``python -m euler_tpu_torch --device_sampling 1`` with
    ``--max_degree`` unset, as the JAX CLI runs it, on a power-law graph
    whose widest row passes 1,024 (``build_powerlaw(*WIDE_CLI_GRAPH)``,
    ppi's widths, written as ``.dat`` files by ``datasets.write_dat``):
    cli_wide_supervised (``--model graphsage_supervised``: B1 once a step
    at the slab's width) and cli_wide_graphsage (``--model graphsage``: B2
    for the positives, B1 for the fanouts), each for WIDE_CLI_EPOCHS
    epochs in a process of its own. On the parent commit both raised:
    the kernels' wrappers refused a slab wider than 1,024. Their launches
    are read from the processes' ``kernel launches`` lines."""
    from euler_tpu_torch import datasets

    t0 = time.perf_counter()
    data = datasets.build_powerlaw(
        *WIDE_CLI_GRAPH, feature_dim=PPI_FEATURE_DIM, label_dim=PPI_LABEL_DIM,
        multilabel=True, seed=seed + 5)
    deg = np.diff(data["indptr"])
    data_dir = os.path.join(work, "wide")
    datasets.write_dat(data, data_dir)
    del data
    log(f"(h) power-law graph {WIDE_CLI_GRAPH[0]} nodes, {int(deg.sum())} "
        f"edges, widest row {int(deg.max())} ({int((deg > 1024).sum())} rows "
        f"past 1,024), written in {time.perf_counter() - t0:.2f} s")
    if not deg.max() > 1024:
        raise AssertionError("(h) no row passes 1,024")
    runs = {}
    steps = WIDE_CLI_EPOCHS * (WIDE_CLI_GRAPH[0] // PPI_BATCH)
    for name, model in (("cli_wide_supervised", "graphsage_supervised"),
                        ("cli_wide_graphsage", "graphsage")):
        argv = list(RUN_LOOP_ARGS)
        argv[argv.index("--num_epochs") + 1] = str(WIDE_CLI_EPOCHS)
        argv[argv.index("--model") + 1] = model
        argv += ["--data_dir", data_dir, "--model_dir",
                 os.path.join(work, name), "--max_id",
                 str(WIDE_CLI_GRAPH[0] - 1), "--seed", str(seed),
                 "--device_sampling", "1"]
        secs, out = run_cmd([sys.executable, "-m", "euler_tpu_torch", *argv],
                            name)
        launches = launch_line(out, name)
        losses = [float(x) for x in re.findall(r"step=\d+ loss=(\S+)", out)]
        log(f"(h) {name}: {secs:.2f} s, {len(losses)} steps, loss "
            f"{np.mean(losses[:10]):.5f} (first 10) -> "
            f"{np.mean(losses[-10:]):.5f} (last 10), launches {launches} "
            f"(card: {smi})")
        if len(losses) != steps or not np.isfinite(losses).all():
            raise AssertionError(f"(h) {name}: {len(losses)} steps (want "
                                 f"{steps}), losses finite: "
                                 f"{np.isfinite(losses).all()}")
        want = {"sample_fanout2": 1 if model == "graphsage_supervised" else 3,
                "sample_neighbor": 0 if model == "graphsage_supervised"
                else 1}
        for k, per in want.items():
            if launches[k] < per * steps or (per == 0 and launches[k]):
                raise AssertionError(f"(h) {name}: {k} launched "
                                     f"{launches[k]} times in {steps} steps")
        if model == "graphsage_supervised" and not (
                np.mean(losses[-10:]) < np.mean(losses[:10])):
            raise AssertionError(f"(h) {name}: the loss did not fall")
        runs[name] = {"launches": launches, "steps": steps}
    return runs


def serve_traffic(max_id: int, seed: int, n: int = SERVE_REQUESTS) -> list:
    """``n`` requests of 1 to SERVE_MAX_IDS ids: each id from the hot set
    or the whole graph by a fair coin, a quarter of the requests with
    their first id repeated at the end."""
    rng = np.random.default_rng(seed)
    hot = rng.choice(max_id + 1, SERVE_HOT, replace=False)
    reqs = []
    for _ in range(n):
        k = int(rng.integers(1, SERVE_MAX_IDS + 1))
        ids = np.where(rng.random(k) < 0.5, rng.choice(hot, k),
                       rng.integers(0, max_id + 1, k))
        if rng.random() < 0.25:
            ids = np.append(ids, ids[0])
        reqs.append([int(i) for i in ids])
    return reqs


def serve_cli(argv, device: str, module: str = "euler_tpu_torch.serve"):
    """``python -m <module> argv`` (the serve CLI, or ``euler_tpu_torch``
    with ``--serve_after``) in a subprocess (on the CPU for a rehearsal,
    through its ``main(device="cpu")``), with its output read on a
    thread; returns the process, its output lines and the address its
    frontend logged (waits up to 300 s for it)."""
    if device == "cuda":
        cmd = [sys.executable, "-m", module, *argv]
    else:
        main_of = ("euler_tpu_torch.run_loop" if module == "euler_tpu_torch"
                   else module)
        cmd = [sys.executable, "-c",
               f"import sys; from {main_of} import main; "
               "sys.exit(main(sys.argv[1:], device='cpu'))", *argv]
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        cmd, cwd=root, env=dict(os.environ, PYTHONPATH=root),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, found = [], threading.Event()
    addr = {}

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.search(r"serving embeddings on (\S+)", line)
            if m:
                addr["a"] = m.group(1)
                found.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    deadline = time.monotonic() + 300
    while not found.wait(0.5):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            proc.wait(10)
            raise AssertionError("the serve CLI never served:\n"
                                 + "\n".join(lines[-40:]))
    return proc, lines, addr["a"], reader


def drive_clients(address: str, reqs: list, clients: int,
                  name: str) -> tuple:
    """``reqs`` sent over the wire by ``clients`` ``EmbedClient`` threads
    (request k by thread k % clients); returns each request's rows, its
    latency ms at the client and the wall seconds. Raises if a client
    failed or hung."""
    from euler_tpu_torch.serving import EmbedClient

    results = [None] * len(reqs)
    errors = []

    def client(k0):
        c = EmbedClient(address, timeout_s=60.0)
        try:
            for k in range(k0, len(reqs), clients):
                t = time.perf_counter()
                rows = c.embed(reqs[k])
                results[k] = (rows, (time.perf_counter() - t) * 1e3)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))
        finally:
            c.close()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or None in results:
        raise AssertionError(f"{name} clients failed: {errors[:5]}")
    return ([r[0] for r in results], np.array([r[1] for r in results]),
            wall)


def check_direct(server, reqs: list, rows: list, name: str) -> dict:
    """Every served row bit-equal to ``embed_direct``; returns ``{id:
    row}``."""
    direct = {}
    for req, got in zip(reqs, rows):
        for nid, row in zip(req, got):
            if nid not in direct:
                direct[nid] = server.embed_direct(nid)
            if not np.array_equal(row, direct[nid]):
                raise AssertionError(
                    f"{name}: served row of id {nid} differs from "
                    f"embed_direct (max abs {np.abs(row - direct[nid]).max()})")
    return direct


def cpu_bucket_err(model, graph, server, blocks: list, lr: float,
                   name: str, device: str) -> float:
    """One forward of ``blocks`` on the server's device against the CPU's
    eager forward of the same blocks (the module and stores copied to
    the CPU), within SERVE_CPU_RTOL / SERVE_CPU_ATOL; returns the max
    abs error."""
    from euler_tpu_torch import serve
    from euler_tpu_torch import train as train_lib

    cpu_state = model.init_state(
        graph, train_lib.get_optimizer("adam", lr), device="cpu")
    cpu_state["module"].load_state_dict(
        {k: v.cpu() for k, v in
         server._state["module"].state_dict().items()})
    for dst, src in zip(cpu_state.get("stores", ()),
                        server._state.get("stores", ())):
        dst.copy_(src.cpu())
    cpu = serve.EmbedServer(model, graph, cpu_state,
                            max_batch=SERVE_MAX_BATCH)
    want, got = cpu._forward(blocks), server._forward(blocks)
    err = float(np.abs(got - want).max())
    if not np.allclose(got, want, rtol=SERVE_CPU_RTOL, atol=SERVE_CPU_ATOL):
        raise AssertionError(f"{name} bucket on {device} against the CPU: "
                             f"max abs err {err}")
    return err


def check_serve_cli(argv, device: str, probe: int, probe_row,
                    what: str) -> str:
    """``python -m euler_tpu_torch.serve argv`` answers id ``probe`` over
    the wire bit-equal to ``probe_row`` and drains to exit code 0 on
    SIGTERM; returns the line to log."""
    from euler_tpu_torch.serving import EmbedClient

    t0 = time.perf_counter()
    proc, lines, addr, reader = serve_cli(argv, device)
    try:
        up = time.perf_counter() - t0
        c = EmbedClient(addr, timeout_s=60.0)
        row = c.embed([probe])[0]
        c.close()
        if not np.array_equal(row, probe_row):
            raise AssertionError(f"the serve CLI's row ({what}) differs "
                                 "from the in-process server's")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    reader.join(10)
    if rc != 0 or not any("serve SLO at exit" in x for x in lines):
        raise AssertionError(f"the serve CLI ({what}) exited {rc}:\n"
                             + "\n".join(lines[-40:]))
    return (f"python -m euler_tpu_torch.serve {what} served on {addr} "
            f"after {up:.2f} s; id {probe}'s row over the wire bit-equal "
            f"to the in-process server's; SIGTERM drained it to exit code "
            f"{rc}")


def phase_serve(data_dir: str, model_dir: str, seed: int, smi: str,
                device: str = "cuda", max_id: int = 56943) -> dict:
    """serve_ppi: run_loop_host's checkpoint (phase 5 (f)) served at ppi's
    widths. (a) ``serve.run_serve`` restores it into ``build_server``
    (max_batch 64, max_wait_us 2000) behind an ``EmbedFrontend``; the
    first dispatch captures the bucket's CUDA graph; (b) SERVE_CLIENTS
    client threads send SERVE_REQUESTS requests (``serve_traffic``); (c)
    every served row equals ``embed_direct`` on the card bit for bit; (d)
    one bucket equals the CPU's eager forward of the same blocks within
    SERVE_CPU_RTOL / SERVE_CPU_ATOL; (e) exactly one capture, no
    re-capture and no B1 or B2 launch; (f) cold and warm dispatches are
    timed; (g) ``python -m euler_tpu_torch.serve`` on the same
    checkpoint answers one embed over the wire, bit-equal to the
    in-process row, and drains to exit code 0 on SIGTERM."""
    log("== phase 6: serve_ppi")
    from euler_tpu_torch import run_loop, serve
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import native, sampling_kernels

    argv = ["--data_dir", data_dir, "--model_dir", model_dir,
            "--max_id", str(max_id), "--seed", str(seed), *RUN_LOOP_ARGS,
            "--serve_port", "0", "--serve_max_batch", str(SERVE_MAX_BATCH),
            "--serve_max_wait_us", str(SERVE_WAIT_US)]
    args = run_loop.define_flags().parse_args(argv)
    args.mode = "evaluate"  # serve.main's inference config
    graph, _ = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    native.reset_counters()
    T.telemetry_reset()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    server, frontend = serve.run_serve(model, graph, args, device,
                                       block=False)
    try:
        # (a) the first dispatch captures the bucket
        t0 = time.perf_counter()
        server.embed_direct(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        # (b) concurrent mixed traffic through the frontend
        reqs = serve_traffic(max_id, seed)
        results, lat, wall = drive_clients(frontend.address, reqs,
                                           SERVE_CLIENTS, "serve_ppi")
        stats = server.stats()
        launches = dict(sampling_kernels.launches)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        log(f"(b) {SERVE_REQUESTS} requests from {SERVE_CLIENTS} clients "
            f"({sum(len(r) for r in reqs)} ids, "
            f"{len({i for r in reqs for i in r})} distinct) in {wall:.3f} s"
            f": request latency at the client p50 "
            f"{np.percentile(lat, 50):.4f} ms, p99 "
            f"{np.percentile(lat, 99):.4f} ms; SLO tracker {stats['slo']}; "
            f"serve phases {stats['serve_phases']}; dispatches "
            f"{stats['batch']}; counters {stats['counters']}; bucket "
            f"{stats['devprof']}; first dispatch (capture) "
            f"{first_ms:.3f} ms; sample cache {stats['cache']} (host "
            f"bytes); max_memory_allocated {peak} B (card: {smi})")
        # (c) bit parity with the direct path
        direct = check_direct(server, reqs, results, "serve_ppi")
        log(f"(c) every served row ({sum(len(r) for r in reqs)}) bit-equal "
            f"to embed_direct on {device} ({len(direct)} ids)")
        # (d) one bucket against the CPU's eager forward
        uids = sorted(direct)[:SERVE_MAX_BATCH]
        err = cpu_bucket_err(model, graph, server,
                             [server._block(i) for i in uids], PPI_LR,
                             "serve_ppi", device)
        log(f"(d) one bucket of {len(uids)} ids on {device} against the "
            f"CPU's eager forward: max abs err {err:.3e} (rtol "
            f"{SERVE_CPU_RTOL}, atol {SERVE_CPU_ATOL})")
        # (e) one capture, no re-capture, no kernel launch
        dev = server.stats()["devprof"]
        if (dev["captures"], dev["recaptures"], dev["serve_recompiles"]) != (
                1, 0, 0):
            raise AssertionError(f"serve_ppi bucket {dev}")
        if any(launches.values()):
            raise AssertionError(f"serve_ppi launched {launches}")
        # (f) cold (sampling 64 new ids) and warm (all cached) dispatches
        cold_ids = np.setdiff1d(
            np.random.default_rng(seed + 1).permutation(max_id + 1),
            np.fromiter(server._cache, np.int64))[:SERVE_MAX_BATCH]
        t0 = time.perf_counter()
        server._embed_unique(cold_ids)
        cold_ms = (time.perf_counter() - t0) * 1e3
        warm = []
        for _ in range(SERVE_WARM_RUNS):
            t0 = time.perf_counter()
            server._embed_unique(cold_ids)
            warm.append((time.perf_counter() - t0) * 1e3)
        # the warm dispatch's parts: staging (steps 1-2, host clock to a
        # sync) and the replay alone (CUDA events)
        stage_ms = replay_ms = "not measured"
        if device == "cuda":
            bucket = server._bucket
            padded = [server._block(int(i)) for i in cold_ids]
            times = []
            for _ in range(SERVE_WARM_RUNS):
                t0 = time.perf_counter()
                bucket._stage(padded)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            stage_ms = f"{statistics.median(times):.4f} ms"
            replay_ms = f"{cuda_ms(bucket._graph.replay):.4f} ms"
        dev = server.stats()["devprof"]
        up = sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                 for _, shape, dt in server._bucket.signature)
        log(f"(e) captures {dev['captures']}, re-captures "
            f"{dev['recaptures']}, replays {dev['replays']}, launches "
            f"{launches}; (f) one dispatch of {SERVE_MAX_BATCH} ids: cold "
            f"(64 host samples) {cold_ms:.4f} ms, warm (cached) median "
            f"{statistics.median(warm):.4f} ms over {SERVE_WARM_RUNS} "
            f"(min {min(warm):.4f}, max {max(warm):.4f}), of which staging "
            f"{stage_ms} (median, to a sync) and the graph's replay "
            f"{replay_ms} (device, median of 40); "
            f"{up} B up and "
            f"{SERVE_MAX_BATCH * PPI_DIM * 4} B down a full dispatch; a "
            f"block {stats['cache']['bytes'] // stats['cache']['entries']}"
            f" B (card: {smi})")
        probe = int(reqs[0][0])
        probe_row = direct[probe]
    finally:
        frontend.drain(grace_s=1.0)
        server.close()
        frontend.stop()
        graph.close()
    # (g) the serve CLI, drained by SIGTERM
    log("(g) " + check_serve_cli(argv, device, probe, probe_row,
                                 "(serve_ppi)"))
    return {"serve_ppi": {"launches": launches}}


def zoo_work(model: str, batch: dict) -> tuple:
    """(count, unit) of one step's work of ``--model`` ``model``: the
    aggregated (masked-in) edges of the GCN family, counted on ``batch``;
    sampled edges of the single-hop models; skip-gram pairs of the walk
    models and lshne; labelled rows of saved_embedding."""
    if model == "gcn":
        return sum(float(a["mask"].sum()) for a in batch["adjs"]), \
            "aggregated edges"
    if model == "scalable_gcn":
        return float(batch["adj"]["mask"].sum()), "aggregated edges"
    if model == "scalable_sage":
        return PPI_BATCH * SSAGE_FANOUT, "sampled edges"
    if model == "gat":
        return PPI_BATCH * GAT_NB, "sampled edges"
    if model in ("line", "node2vec"):
        return len(batch["src"]["ids"]), "pairs"
    if model == "lshne":
        return LSHNE_PAIRS, "pairs"
    return PPI_BATCH, "labelled rows"


def zoo_path(name: str, data_dir: str, model_dir: str, extra, seed: int,
             smi: str, device: str, max_id: int) -> dict:
    """One host-sampled run_loop model, with the launch counts set to 0
    just before it and read just after: (a) a CPU/CUDA agreement on one
    host batch of ZOO_AGREE_ROOTS roots; (b) one full batch's bytes and
    upload ms; (c) ``--mode train`` for one epoch, the loss finite and,
    on the first ZOO_REPLAY_STEPS batches replayed, lower than at init
    (and, but for line, falling from the first ten steps to the last);
    (d) ``--mode evaluate`` and ``--mode save_embedding``: the metric in
    [0, 1], the export finite and equal (walk models, saved_embedding:
    bit for bit, the table itself) or close by row cosine to a fresh
    export of the restored state; (e) a profiler window of 10 steps."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.graph import sampling_kernels
    from euler_tpu_torch.models import base

    argv = ["--data_dir", data_dir, "--model_dir", model_dir,
            "--max_id", str(max_id), "--seed", str(seed), *RUN_LOOP_ARGS,
            *extra]
    args = run_loop.define_flags().parse_args(argv)
    graph, _ = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    assert not model.device_sampling
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    roots = graph.sample_node(ZOO_AGREE_ROOTS, args.train_node_type)
    agree_cpu_cuda(model, graph, seed, name,
                   host_batch=model.sample(graph, roots))
    t_agree = time.perf_counter() - t0
    full = model.sample(graph, graph.sample_node(
        PPI_BATCH * model.batch_size_ratio, args.train_node_type))
    work, unit = zoo_work(args.model, full)
    nbytes = sum(x.nbytes for _, x in base.batch_leaves(full))
    up = []
    for _ in range(5):
        t0 = time.perf_counter()
        base.to_device(full, device)
        torch.cuda.synchronize()
        up.append((time.perf_counter() - t0) * 1e3)
    del full

    # (c) train one epoch, keeping the first batches the training thread
    # uploads, in step order
    first = []
    real_up = base.to_device

    def recording(batch, dev=None):
        if len(first) < ZOO_REPLAY_STEPS:
            first.append(batch)
        return real_up(batch, dev)

    base.to_device = recording
    try:
        t0 = time.perf_counter()
        windows = run_loop_main(argv, device)
        wall = time.perf_counter() - t0
    finally:
        base.to_device = real_up
    steps = (max_id + 1) // PPI_BATCH
    losses = np.array([w[1] for w in windows])
    if len(windows) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: {len(windows)} logged steps of "
                             f"{steps}, losses {losses}")
    head, tail = losses[:10].mean(), losses[-10:].mean()
    if args.model != "line" and not tail < head:
        raise AssertionError(f"{name}: loss did not fall ({head} -> {tail})")
    latest = Checkpointer(model_dir).latest_step()
    if latest != steps:
        raise AssertionError(f"{name}: latest checkpoint {latest}, "
                             f"expected {steps}")
    restored = run_loop._restore_state(model, graph, args, device)
    init = model.init_state(
        graph, train_lib.get_optimizer(args.optimizer, args.learning_rate),
        device=device, seed=args.seed)
    ev = model.make_eval_step()
    replay = [float(np.mean([float(ev(st, real_up(b, device))[0])
                             for b in first])) for st in (init, restored)]
    if not replay[1] < replay[0]:
        raise AssertionError(f"{name}: the loss of its first "
                             f"{ZOO_REPLAY_STEPS} batches did not fall "
                             f"({replay})")
    step_ms = statistics.median(w[2] for w in windows[10:])
    stall_ms = float(np.mean([w[3] for w in windows[10:]]))
    stalled = sum(w[4] for w in windows)
    sample_ms = float(np.mean([w[5] for w in windows]))
    log(f"{name} train: run_loop.main {wall:.2f} s, {steps} steps, loss "
        f"{head:.5f} (first 10) -> {tail:.5f} (last 10); its first "
        f"{ZOO_REPLAY_STEPS} batches replayed: {replay[0]:.5f} at init, "
        f"{replay[1]:.5f} trained; step {step_ms:.4f} ms (median of steps "
        f"11-{steps}, each synced by --log_steps 1), {work:.0f} {unit}/step"
        f", {work / step_ms * 1e3:.1f} {unit}/s, batch build "
        f"{sample_ms:.4f} ms in a prefetch worker, input stall "
        f"{stall_ms:.4f} ms a step, {stalled} of {steps} steps waited over "
        f"1 ms; a batch {nbytes} B, uploaded (pinned, to a sync) in "
        f"{statistics.median(up):.4f} ms (median of 5); agreement "
        f"{t_agree:.2f} s (card: {smi})")

    # (d) evaluate and export
    t0 = time.perf_counter()
    run_loop_main(argv + ["--mode", "evaluate"], device)
    with open(os.path.join(model_dir, "eval.json")) as f:
        result = json.load(f)
    metric = result[model.metric_name]
    if not (0.0 <= metric <= 1.0 and np.isfinite(result["loss"])):
        raise AssertionError(f"{name}: eval {result}")
    run_loop_main(argv + ["--mode", "save_embedding"], device)
    emb = np.load(os.path.join(model_dir, "embedding.npy"))
    if emb.shape[0] != max_id + 1 or not np.isfinite(emb).all():
        raise AssertionError(f"{name}: embedding.npy {emb.shape}")
    if args.model in ("line", "node2vec"):
        table = restored["module"].target.embedding.embeddings
        same = np.array_equal(emb, table[:max_id + 1].detach().cpu().numpy())
        how = "bit-equal to the trained id table"
    elif args.model == "saved_embedding":
        same = np.array_equal(emb, model.embedding[:max_id + 1])
        how = "bit-equal to the frozen table"
    else:
        fresh = train_lib.save_embedding(model, 4095, restored,
                                         batch_size=PPI_BATCH, device=device,
                                         graph=graph)
        a, b = emb[:4096], fresh
        cos = (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)
        b = np.roll(b, 1, axis=0)
        other = (a * b).sum(1) / np.maximum(
            np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-12)
        same = np.median(cos) > np.median(other) + EXPORT_COSINE_MARGIN
        how = (f"against a fresh export of ids 0-4095, row cosine median "
               f"{np.median(cos):.6f} (the next id's row: "
               f"{np.median(other):.6f})")
    if not same:
        raise AssertionError(f"{name}: embedding.npy is not the restored "
                             f"state's export ({how})")
    peak = torch.cuda.max_memory_allocated()
    log(f"{name} evaluate and save_embedding: "
        f"{time.perf_counter() - t0:.2f} s, eval over every id {result}, "
        f"embedding.npy {emb.shape} {how}; max_memory_allocated {peak} B")
    # (e) the profiler window
    log(f"{name} train.train profiled over steps 11-20: " + profile_host_steps(
        model, graph, lambda step: graph.sample_node(
            PPI_BATCH * model.batch_size_ratio, args.train_node_type),
        seed, device) + f" (card: {smi})")
    graph.close()
    launches = dict(sampling_kernels.launches)
    if any(launches.values()):
        raise AssertionError(f"{name} launched {launches}")
    return {"launches": launches, "steps": steps, "step_ms": step_ms,
            "peak_bytes": peak}


def lasgnn_host_inputs(graph, batch: int) -> dict:
    """LasGNN's structured inputs drawn on the host, as
    ``lasgnn_inputs`` draws them on the card: targets of any type; the
    first half of the rows positives, two neighbors of the target over
    edge types [0, 1], label 1; the rest two sampled nodes, label 0."""
    roots = graph.sample_node(batch, -1)
    half = batch // 2
    pos = graph.sample_neighbor(roots[:half], [0, 1], 2, -1)[0]
    neg = graph.sample_node(2 * (batch - half), -1).reshape(-1, 2)
    label = np.concatenate([np.ones(half), np.zeros(batch - half)])
    return {"label": label[:, None].astype(np.float32),
            "groups": [roots[:, None], np.concatenate([pos, neg])]}


def zoo_lasgnn(graph, seed: int, smi: str, device: str,
               model_dir: str) -> dict:
    """LasGNN host-sampled through ``train.train`` over the engine, on
    host-drawn inputs, for ZOO_LASGNN_STEPS steps (the state then saved
    in ``model_dir``, which phase 10 serves), then ``train.evaluate``
    over EVAL_BATCHES fresh batches and a profiler window of 10 steps;
    the counts set to 0 just before and read just after."""
    from euler_tpu_torch import train
    from euler_tpu_torch.checkpoint import Checkpointer
    from euler_tpu_torch.graph import sampling_kernels

    max_id = graph.num_nodes - 1
    model = lasgnn(max_id, device_sampling=False)
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    agree_cpu_cuda(model, graph, seed, "lasgnn_host", host_batch=model.sample(
        graph, lasgnn_host_inputs(graph, ZOO_AGREE_ROOTS)))
    t0 = time.perf_counter()
    state, history = train.train(
        model, graph, lambda step: lasgnn_host_inputs(graph, PPI_BATCH),
        num_steps=ZOO_LASGNN_STEPS, learning_rate=PPI_LR, log_every=1,
        seed=seed, device=device, log_fn=lambda msg: None)
    wall = time.perf_counter() - t0
    ckpt = Checkpointer(model_dir)
    ckpt.save(ZOO_LASGNN_STEPS, state, force=True)
    ckpt.close()
    losses = np.array([h["loss"] for h in history])
    head, tail = losses[:10].mean(), losses[-10:].mean()
    if not (np.isfinite(losses).all() and tail < head):
        raise AssertionError(f"lasgnn host losses {head} -> {tail}")
    step_ms = statistics.median(1e3 / h["steps_per_sec"]
                                for h in history[10:])
    f1, f2 = PPI_FANOUTS
    roots = sum(PPI_BATCH * n * len(m)
                for n, m in zip(LASGNN_GROUP_SIZES, LASGNN_METAPATHS))
    edges = roots * (f1 + f1 * f2)
    result = train.evaluate(
        model, graph, [lasgnn_host_inputs(graph, PPI_BATCH)
                       for _ in range(EVAL_BATCHES)], state, device=device)
    if not (0.0 <= result["auc"] <= 1.0 and np.isfinite(result["loss"])):
        raise AssertionError(f"lasgnn host evaluate {result}")
    profiled = profile_host_steps(
        model, graph, lambda step: lasgnn_host_inputs(graph, PPI_BATCH),
        seed, device)
    launches = dict(sampling_kernels.launches)
    if any(launches.values()):
        raise AssertionError(f"lasgnn host launched {launches}")
    log(f"lasgnn_host train: train.train {wall:.2f} s, "
        f"{ZOO_LASGNN_STEPS} steps, loss {head:.5f} (first 10) -> "
        f"{tail:.5f} (last 10), step {step_ms:.4f} ms (median of steps "
        f"11-{ZOO_LASGNN_STEPS}), {edges} sampled edges/step, "
        f"{edges / step_ms * 1e3:.1f} edges/s, batch build "
        f"{np.mean([h['sample_ms'] for h in history]):.4f} ms in a "
        f"prefetch worker, input stall "
        f"{np.mean([h['input_stall_ms'] for h in history[10:]]):.4f} ms a "
        f"step, {sum(h['stalled_steps'] for h in history)} steps waited; "
        f"evaluate {result} over {EVAL_BATCHES} fresh batches; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"train.train profiled over steps 11-20: {profiled} (card: {smi})")
    return {"launches": launches, "steps": ZOO_LASGNN_STEPS,
            "step_ms": step_ms,
            "peak_bytes": torch.cuda.max_memory_allocated()}


def phase_zoo(work: str, seed: int, smi: str, device: str = "cuda",
              ppi: dict | None = None) -> dict:
    """The host-sampled model zoo on phase 5's ppi files (``work/ppi``)
    and phase 5 (f)'s export (``work/m2/embedding.npy``): gcn's and
    scalable_gcn's host expansion at the CLI's caps raises (hop 1
    outgrows them), then ``zoo_path`` for gcn and scalable_gcn (at
    ZOO_GCN_FANOUTS), scalable_sage, gat, gat with --device_features 1,
    line, node2vec and saved_embedding; the heterogeneous variant written
    as .dat files (``datasets.write_dat``) and lshne over it; then LasGNN
    through ``train.train`` (``zoo_lasgnn``). B1 and B2 launch on none of
    these paths."""
    log("== phase 7: host-sampled model zoo")
    from euler_tpu_torch import datasets, run_loop
    from euler_tpu_torch.graph import Graph

    ppi = ppi or datasets.PPI
    max_id = ppi["num_nodes"] - 1
    data_dir = os.path.join(work, "ppi")
    runs = {}
    base_argv = ["--data_dir", data_dir, "--max_id", str(max_id),
                 *RUN_LOOP_ARGS]
    graph = Graph(directory=data_dir)
    for model_name in ("gcn", "scalable_gcn"):
        args = run_loop.define_flags().parse_args(
            base_argv + ["--model", model_name])
        model = run_loop.build_model(args, graph)
        try:
            model.sample(graph, graph.sample_node(PPI_BATCH, 0))
        except ValueError as e:
            log(f"{model_name} at the CLI's caps (fanouts "
                f"{args.fanouts}): the host expansion raises, as the JAX "
                f"package's: {e}")
        else:
            raise AssertionError(f"{model_name}: the host expansion at the "
                                 "CLI's caps did not raise")
    graph.close()
    fan = ["--fanouts", ",".join(map(str, ZOO_GCN_FANOUTS))]
    emb_file = os.path.join(work, "m2", "embedding.npy")
    # the cells' names: phase 4's device-sampled paths hold the bare ones
    for name, extra in (
            ("gcn_host", ["--model", "gcn", *fan]),
            ("scalable_gcn_host", ["--model", "scalable_gcn", *fan]),
            ("scalable_sage_host", ["--model", "scalable_sage"]),
            ("gat_host", ["--model", "gat"]),
            ("gat_host_device_features", ["--model", "gat",
                                          "--device_features", "1"]),
            ("line_host", ["--model", "line"]),
            ("node2vec_host", ["--model", "node2vec"]),
            ("saved_embedding", ["--model", "saved_embedding",
                                 "--embedding_file", emb_file])):
        t0 = time.perf_counter()
        runs[name] = zoo_path(name, data_dir, os.path.join(work, "z_" + name),
                              extra, seed, smi, device, max_id)
        log(f"{name} path: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    het_dir = os.path.join(work, "het")
    datasets.write_dat(hetero_variant(datasets.build_synthetic(**ppi),
                                      seed + 3), het_dir, num_partitions=4)
    graph = Graph(directory=het_dir)
    ids = np.array([0, 1, max_id])
    got = graph.get_sparse_feature(ids, [0])[0]
    if not (np.array_equal(got[0], ids) and np.array_equal(got[1], [1, 1, 1])
            and graph.node_type_num == HET_NODE_TYPES
            and graph.edge_type_num == 2):
        raise AssertionError(f"the heterogeneous .dat files: slot 0 {got}, "
                             f"{graph.node_type_num} node types")
    log(f"heterogeneous variant written as .dat and loaded in "
        f"{time.perf_counter() - t0:.2f} s: {graph.num_nodes} nodes, "
        f"{graph.node_type_num} node types, 2 edge types, uint64 slot 0 "
        f"the node's id")
    t0 = time.perf_counter()
    runs["lshne_host"] = zoo_path(
        "lshne_host", het_dir, os.path.join(work, "z_lshne"),
        ["--model", "lshne", "--feature_idx", "0"], seed, smi, device,
        max_id)
    log(f"lshne_host path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    runs["lasgnn_host"] = zoo_lasgnn(graph, seed, smi, device,
                                     os.path.join(work, "z_lasgnn"))
    log(f"lasgnn_host path: {time.perf_counter() - t0:.1f} s")
    graph.close()
    return runs


def serve_zoo_path(name: str, argv: list, seed: int, smi: str, device: str,
                   max_id: int, model=None) -> tuple:
    """One served checkpoint, the launch counts set to 0 just before and
    read just after: (a) ``serve.run_serve`` restores ``--model_dir``
    (``model``, when given, in place of ``run_loop.build_model``'s, in the
    inference config) and the first dispatch captures the bucket; (b)
    ZOO_SERVE_CLIENTS client threads send ZOO_SERVE_REQUESTS requests each
    (``serve_traffic``); (c) every served row equals ``embed_direct`` bit
    for bit; (d) one bucket (the first forward of 64 served ids) equals
    the CPU's eager forward of its blocks within SERVE_CPU_RTOL /
    SERVE_CPU_ATOL; (e) one capture, no re-capture, no B1 or B2 launch;
    (f) a cold (64 new ids) and a warm (cached) dispatch are timed.
    Returns ``({name: {"launches": ...}}, a served (id, row))``."""
    from euler_tpu_torch import run_loop, serve
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import native, sampling_kernels

    args = run_loop.define_flags().parse_args(argv)
    args.mode = "evaluate"  # serve.main's inference config
    graph, _ = run_loop.build_graph(args)
    model = model or run_loop.build_model(args, graph)
    native.reset_counters()
    T.telemetry_reset()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    server, frontend = serve.run_serve(model, graph, args, device,
                                       block=False)
    try:
        up_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        server.embed_direct(0)
        first_ms = (time.perf_counter() - t0) * 1e3
        reqs = serve_traffic(max_id, seed,
                             ZOO_SERVE_CLIENTS * ZOO_SERVE_REQUESTS)
        results, lat, wall = drive_clients(frontend.address, reqs,
                                           ZOO_SERVE_CLIENTS, name)
        stats = server.stats()
        forwards = stats["counters"].get("serve_batches", 0) / max(
            stats["batch"].get("dispatches", 1), 1)
        # (c) bit parity with the direct path
        direct = check_direct(server, reqs, results, name)
        # (d) one bucket against the CPU's eager forward
        blocks = server._layout.split(
            [server._block(i) for i in sorted(direct)[:SERVE_MAX_BATCH]])[0]
        err = cpu_bucket_err(model, graph, server, blocks,
                             args.learning_rate, name, device)
        # (e) one capture, no re-capture, no kernel launch
        launches = dict(sampling_kernels.launches)
        dev = server.stats()["devprof"]
        if (dev["captures"], dev["recaptures"], dev["serve_recompiles"]) != (
                1, 0, 0):
            raise AssertionError(f"{name} bucket {dev}")
        if any(launches.values()):
            raise AssertionError(f"{name} launched {launches}")
        # (f) cold (sampling 64 new ids) and warm (all cached) dispatches
        cold_ids = np.setdiff1d(
            np.random.default_rng(seed + 1).permutation(max_id + 1),
            np.fromiter(server._cache, np.int64))[:SERVE_MAX_BATCH]
        t0 = time.perf_counter()
        server._embed_unique(cold_ids)
        cold_ms = (time.perf_counter() - t0) * 1e3
        h2d0, rep0 = dev["h2d_bytes"], dev["replays"]
        warm = []
        for _ in range(ZOO_SERVE_WARM_RUNS):
            t0 = time.perf_counter()
            server._embed_unique(cold_ids)
            warm.append((time.perf_counter() - t0) * 1e3)
        dev = server.stats()["devprof"]
        per_fwd = (dev["h2d_bytes"] - h2d0) / max(dev["replays"] - rep0, 1)
        groups = server._layout.split(
            [server._block(int(i)) for i in cold_ids])
        # a forward's parts: staging (steps 1-2, host clock to a sync)
        # and the replay alone (CUDA events)
        stage_ms = replay_ms = "not measured"
        if device == "cuda":
            bucket = server._bucket
            times = []
            for _ in range(ZOO_SERVE_WARM_RUNS):
                t0 = time.perf_counter()
                bucket._stage(groups[0])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            stage_ms = f"{statistics.median(times):.4f} ms"
            replay_ms = f"{cuda_ms(bucket._graph.replay):.4f} ms"
        bucket = sum(int(np.prod(shape)) * np.dtype(dt).itemsize
                     for _, shape, dt in server._bucket.signature)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        log(f"{name}: up in {up_s:.2f} s, first dispatch (capture) "
            f"{first_ms:.3f} ms; {len(reqs)} requests from "
            f"{ZOO_SERVE_CLIENTS} clients ({sum(len(r) for r in reqs)} ids, "
            f"{len(direct)} distinct) in {wall:.3f} s: latency at the "
            f"client p50 {np.percentile(lat, 50):.4f} ms, p99 "
            f"{np.percentile(lat, 99):.4f} ms; {forwards:.3f} forwards a "
            f"dispatch; every served row bit-equal to embed_direct; one "
            f"bucket of {len(blocks)} ids against the CPU: max abs err "
            f"{err:.3e}; captures {dev['captures']}, re-captures "
            f"{dev['recaptures']}, launches {launches}; a dispatch of "
            f"{SERVE_MAX_BATCH} ids ({len(groups)} forwards): cold "
            f"{cold_ms:.4f} ms, warm median {statistics.median(warm):.4f} ms"
            f" over {ZOO_SERVE_WARM_RUNS} (min {min(warm):.4f}), a "
            f"forward's staging {stage_ms} (median, to a sync) and replay "
            f"{replay_ms} (device, median of 40); bucket "
            f"{bucket} B, {per_fwd:.0f} B up a forward on average; "
            f"max_memory_allocated {peak} B (card: {smi})")
        probe = int(reqs[0][0])
        probe_row = direct[probe]
    finally:
        frontend.drain(grace_s=1.0)
        server.close()
        frontend.stop()
        graph.close()
    return {name: {"launches": launches}}, (probe, probe_row)


def phase_serve_zoo(work: str, seed: int, smi: str, device: str = "cuda",
                    ppi: dict | None = None) -> dict:
    """Serving the zoo: ``serve_zoo_path`` over phase 7's checkpoints of
    gcn, scalable_gcn, scalable_sage, gat, line, node2vec, saved_embedding
    and lshne, each with the flags it trained with, and over LasGNN's
    saved state; then ``python -m euler_tpu_torch.serve --model gcn``
    answers one embed over the wire, bit-equal to serve_gcn's row, and
    drains to exit code 0 on SIGTERM."""
    log("== phase 10: serving the zoo")
    from euler_tpu_torch import datasets

    ppi = ppi or datasets.PPI
    max_id = ppi["num_nodes"] - 1
    data_dir = os.path.join(work, "ppi")
    het_dir = os.path.join(work, "het")
    fan = ["--fanouts", ",".join(map(str, ZOO_GCN_FANOUTS))]
    serve_flags = ["--serve_port", "0", "--serve_max_batch",
                   str(SERVE_MAX_BATCH), "--serve_max_wait_us",
                   str(SERVE_WAIT_US)]

    def argv(data, model_dir, extra):
        return ["--data_dir", data, "--model_dir",
                os.path.join(work, model_dir), "--max_id", str(max_id),
                "--seed", str(seed), *RUN_LOOP_ARGS, *extra, *serve_flags]

    runs = {}
    probes = {}
    for name, data, model_dir, extra in (
            ("serve_gcn", data_dir, "z_gcn_host", ["--model", "gcn", *fan]),
            ("serve_scalable_gcn", data_dir, "z_scalable_gcn_host",
             ["--model", "scalable_gcn", *fan]),
            ("serve_scalable_sage", data_dir, "z_scalable_sage_host",
             ["--model", "scalable_sage"]),
            ("serve_gat", data_dir, "z_gat_host", ["--model", "gat"]),
            ("serve_line", data_dir, "z_line_host", ["--model", "line"]),
            ("serve_node2vec", data_dir, "z_node2vec_host",
             ["--model", "node2vec"]),
            ("serve_saved_embedding", data_dir, "z_saved_embedding",
             ["--model", "saved_embedding", "--embedding_file",
              os.path.join(work, "m2", "embedding.npy")]),
            ("serve_lshne", het_dir, "z_lshne",
             ["--model", "lshne", "--feature_idx", "0"])):
        t0 = time.perf_counter()
        run, probes[name] = serve_zoo_path(
            name, argv(data, model_dir, extra), seed, smi, device, max_id)
        add_runs(runs, run)
        log(f"{name} path: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    run, _ = serve_zoo_path(
        "serve_lasgnn", argv(het_dir, "z_lasgnn", []), seed, smi, device,
        max_id, model=lasgnn(max_id, device_sampling=False))
    add_runs(runs, run)
    log(f"serve_lasgnn path: {time.perf_counter() - t0:.1f} s")
    # the serve CLI over gcn's checkpoint, drained by SIGTERM
    log(check_serve_cli(
        argv(data_dir, "z_gcn_host", ["--model", "gcn", *fan]), device,
        *probes["serve_gcn"], "--model gcn"))
    return runs


class Shard:
    """One ``python -m euler_tpu_torch.graph.service`` shard process on a
    flat-file registry, its output read on a thread (the serving line
    carries its load time)."""

    def __init__(self, idx: int, data_dir: str, reg: str):
        root = os.path.dirname(os.path.abspath(__file__))
        self.idx, self.reg = idx, reg
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "euler_tpu_torch.graph.service",
             "--data_dir", data_dir, "--shard_idx", str(idx),
             "--shard_num", str(REMOTE_SHARDS), "--registry", reg],
            cwd=root, env=dict(os.environ, PYTHONPATH=root),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self.lines = []
        self.up = threading.Event()
        self.reader = threading.Thread(target=self._read, daemon=True)
        self.reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if "serving on" in line:
                self.up.set()

    def wait_up(self, timeout: float = SHARD_WAIT_S) -> tuple:
        """Wait until the shard logged that it serves and its registry
        entry accepts a connection; ``(load seconds as the shard logged
        them, seconds from launch)``."""
        deadline = time.monotonic() + timeout
        while not self.up.wait(0.1):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"shard {self.idx} never served:\n"
                                     + "\n".join(self.lines[-20:]))
        while True:
            for f in os.listdir(self.reg):
                # entries are written under a .tmp name, then renamed
                if f.startswith(f"{self.idx}#") and not f.endswith(".tmp"):
                    host, port = f.split("#", 1)[1].rsplit("_", 1)
                    try:
                        with socket.create_connection((host, int(port)), 1):
                            m = re.search(r"loaded in (\S+) s",
                                          "\n".join(self.lines))
                            return (float(m.group(1)),
                                    time.perf_counter() - self.t0)
                    except OSError:
                        pass
            if time.monotonic() > deadline:
                raise AssertionError(f"shard {self.idx} never registered")
            time.sleep(0.05)

    def drain(self) -> int:
        """SIGTERM: the service drains (deregister, finish in-flight
        requests, close) and exits; its exit code."""
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(60)
        self.reader.join(10)
        return rc

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)


def batch_parts(model, graph, seed: int) -> str:
    """The two parts of a host batch of ``model`` over ``graph``, timed
    alone (host clock, median of BREAKDOWN_RUNS batches of PPI_BATCH
    roots): the fanout (submit to take of ``sample_fanout_async`` on a
    remote graph, ``sample_fanout`` on a local one) and the hops'
    feature and label reads (``_batch_from_hops``); then one id's
    serving block (``sample_host_embed``), the unit a cold serve
    dispatch draws once an id."""
    rng = np.random.default_rng(seed)
    fan, feat, block = [], [], []
    for _ in range(BREAKDOWN_RUNS):
        roots = rng.integers(0, model.max_id + 1, PPI_BATCH)
        t0 = time.perf_counter()
        h = graph.sample_fanout_async(roots, model.metapath, model.fanouts,
                                      model.default_node)
        hops = (h.take() if h is not None else graph.sample_fanout(
            roots, model.metapath, model.fanouts, model.default_node))[0]
        t1 = time.perf_counter()
        model._batch_from_hops(graph, roots, hops)
        t2 = time.perf_counter()
        model.sample_host_embed(graph, roots[:1])
        block.append((time.perf_counter() - t2) * 1e3)
        fan.append((t1 - t0) * 1e3)
        feat.append((t2 - t1) * 1e3)
    return (f"fanout {statistics.median(fan):.4f} ms, feature and label "
            f"reads {statistics.median(feat):.4f} ms, one id's serving "
            f"block {statistics.median(block):.4f} ms")


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def ppi_delta(local, ids, data_dir: str, path: str) -> np.ndarray:
    """Write a delta that replaces the nodes ``ids`` with copies whose
    feature slot 1 is raised by 1 (type, weight, neighbours and labels
    read back from ``local``, unchanged); returns their new features."""
    from euler_tpu_torch.graph.convert import pack_block, pack_delta

    with open(os.path.join(data_dir, "meta.json")) as f:
        meta = json.load(f)
    fdim, ldim = PPI_FEATURE_DIM, PPI_LABEL_DIM
    labels = local.get_dense_feature(ids, [0], [ldim])
    feats = local.get_dense_feature(ids, [1], [fdim]) + 1.0
    types, weights = local.node_types(ids), local.node_weights(ids)
    blocks = []
    for i, nid in enumerate(ids):
        neighbor = {}
        for t in range(meta["edge_type_num"]):
            nbr, w, _, _ = local.get_full_neighbor([nid], [t])
            neighbor[str(t)] = dict(zip(map(str, nbr.tolist()), w.tolist()))
        blocks.append(pack_block({
            "node_id": int(nid), "node_type": int(types[i]),
            "node_weight": float(weights[i]), "neighbor": neighbor,
            "uint64_feature": {}, "binary_feature": {}, "edge": [],
            "float_feature": {"0": labels[i].tolist(),
                              "1": feats[i].tolist()}}, meta))
    with open(path, "wb") as f:
        f.write(pack_delta(1, [], [], b"".join(blocks)))
    return feats


def serve_remote(data_dir: str, model_dir: str, reg: str, seed: int,
                 smi: str, device: str, max_id: int, work: str) -> dict:
    """(f) the remote run's checkpoint served over the remote graph:
    SERVE_CLIENTS threads of ``serve_traffic``, rows bit-equal to
    ``embed_direct``; then a delta on shard 0 moves ``cache_gen``,
    evicts the stale blocks, and the rows served after it equal
    ``embed_direct`` over the new graph (and differ where the delta
    changed an id's features)."""
    from euler_tpu_torch import run_loop, serve
    from euler_tpu_torch.graph import Graph, native, sampling_kernels
    from euler_tpu_torch.serving import EmbedClient

    argv = ["--data_dir", data_dir, "--model_dir", model_dir,
            "--max_id", str(max_id), "--seed", str(seed), *RUN_LOOP_ARGS,
            "--graph_mode", "remote", "--registry", reg,
            "--serve_port", "0", "--serve_max_batch", str(SERVE_MAX_BATCH),
            "--serve_max_wait_us", str(SERVE_WAIT_US)]
    args = run_loop.define_flags().parse_args(argv)
    args.mode = "evaluate"  # serve.main's inference config
    graph, services = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    server, frontend = serve.run_serve(model, graph, args, device,
                                       block=False)
    reqs = serve_traffic(max_id, seed)

    def traffic(tag: str) -> dict:
        results = [None] * len(reqs)
        errors = []

        def client(k0):
            c = EmbedClient(frontend.address, timeout_s=60.0)
            try:
                for k in range(k0, len(reqs), SERVE_CLIENTS):
                    t = time.perf_counter()
                    rows = c.embed(reqs[k])
                    results[k] = (rows, (time.perf_counter() - t) * 1e3)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(repr(e))
            finally:
                c.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        wall = time.perf_counter() - t0
        if errors or any(t.is_alive() for t in threads) or None in results:
            raise AssertionError(f"serve_remote clients failed: {errors[:5]}")
        rows = {}
        for req, (got, _) in zip(reqs, results):
            for nid, row in zip(req, got):
                want = server.embed_direct(nid)
                if not np.array_equal(row, want):
                    raise AssertionError(
                        f"serve_remote {tag}: served row of id {nid} differs "
                        f"from embed_direct (max abs "
                        f"{np.abs(row - want).max()})")
                rows[nid] = row
        lat = np.array([r[1] for r in results])
        p50, p99 = np.percentile(lat, 50), np.percentile(lat, 99)
        log(f"(f) serve_remote {tag}: {SERVE_REQUESTS} requests from "
            f"{SERVE_CLIENTS} clients ({sum(len(r) for r in reqs)} ids, "
            f"{len(rows)} distinct) in {wall:.3f} s: client p50 {p50:.4f} "
            f"ms, p99 {p99:.4f} ms against the {args.serve_slo_ms:g} ms SLO "
            f"({'met' if p99 <= args.serve_slo_ms else 'missed'}); SLO "
            f"tracker {server.stats()['slo']}; every served row bit-equal "
            f"to embed_direct on {device}; cache_gen {graph.cache_gen} "
            f"(card: {smi})")
        return rows

    try:
        server.embed_direct(0)  # the first dispatch captures the bucket
        before = traffic("before the delta")
        gen0 = graph.cache_gen
        local = Graph(directory=data_dir)
        distinct = np.array(sorted(before), dtype=np.int64)
        changed = distinct[graph.shard_of(distinct) == 0][:REMOTE_DELTA_IDS]
        path = os.path.join(work, "ppi_shard0.delta.1")
        feats = ppi_delta(local, changed, data_dir, path)
        local.close()
        native.reset_counters()
        epoch = graph.load_delta(path, shard=0)
        got = graph.get_dense_feature(changed, [1], [PPI_FEATURE_DIM])
        if epoch != 1 or not np.array_equal(got, feats):
            raise AssertionError(f"delta on shard 0: epoch {epoch}, the new "
                                 "features not read back")
        if not graph.cache_gen > gen0:
            raise AssertionError(f"cache_gen {gen0} -> {graph.cache_gen} "
                                 "after the delta")
        after = traffic("after the delta")
        evicted = native.counters()["epoch_stale_hits_evicted"]
        moved = sum(not np.array_equal(before[i], after[i]) for i in changed)
        if evicted < len(before) or moved != len(changed):
            raise AssertionError(
                f"after the delta: {evicted} stale hits evicted for "
                f"{len(before)} cached ids, {moved} of {len(changed)} "
                "changed ids' rows moved")
        launches = dict(sampling_kernels.launches)
        log(f"(f) delta on shard 0 ({len(changed)} nodes' features + 1): "
            f"epoch {graph.shard_epoch(0)} / {graph.shard_epoch(1)}, "
            f"cache_gen {gen0} -> {graph.cache_gen}, "
            f"epoch_stale_hits_evicted {evicted} (the {len(before)} cached "
            f"blocks and the client's native cache entries), the rows of "
            f"all {len(changed)} changed ids moved; launches {launches}")
    finally:
        frontend.drain(grace_s=1.0)
        server.close()
        frontend.stop()
        graph.close()
        run_loop.stop_services(services)
    return {"launches": launches}


def rolling_drill(data_dir: str, reg: str, shards: dict, seed: int,
                  smi: str, device: str, max_id: int, clean: list) -> dict:
    """(d) the rolling-restart drill: ``train.train`` of (c)'s model and
    run over the remote graph with the drill's client settings, each
    shard in turn SIGTERM-drained and restarted on a new port at the
    JAX drill's steps; no call may fail, and the final loss (mean of the
    last 5 steps) must land within DRILL_LOSS_TOL of (c)'s."""
    from euler_tpu_torch import run_loop
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.graph import Graph, native, sampling_kernels

    args = run_loop.define_flags().parse_args(
        ["--data_dir", data_dir, "--max_id", str(max_id), "--seed",
         str(seed), *RUN_LOOP_ARGS])
    graph = Graph(mode="remote", registry=reg, **DRILL_CLIENT)
    model = run_loop.build_model(args, graph)
    restarts = []

    def rolling(step):
        idx = DRILL_RESTARTS.get(step)
        if idx is None:
            return
        t0 = time.perf_counter()
        rc = shards[idx].drain()
        if rc != 0 or any(f.startswith(f"{idx}#") for f in os.listdir(reg)):
            raise AssertionError(f"shard {idx}: SIGTERM exit {rc}, registry "
                                 f"{os.listdir(reg)}")
        shards[idx] = Shard(idx, data_dir, reg)
        load_s, up_s = shards[idx].wait_up()
        restarts.append((step, idx, time.perf_counter() - t0, load_s))

    native.reset_counters()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    steps = (max_id + 1) // PPI_BATCH
    t0 = time.perf_counter()
    try:
        _, hist = train_lib.train(
            model, graph, lambda step: graph.sample_node(PPI_BATCH, 0),
            steps, learning_rate=PPI_LR, log_every=1, seed=seed,
            device=device, step_hook=rolling, log_fn=lambda m: None)
    finally:
        graph.close()
    wall = time.perf_counter() - t0
    ctr = native.counters()
    launches = dict(sampling_kernels.launches)
    losses = [h["loss"] for h in hist]
    drilled, base = float(np.mean(losses[-5:])), float(np.mean(clean[-5:]))
    if (ctr["calls_failed"] or ctr["rpc_errors"]
            or not np.isfinite(losses).all() or not drilled < losses[0]
            or abs(drilled - base) >= DRILL_LOSS_TOL
            or len(restarts) != len(DRILL_RESTARTS) or not ctr["retries"]
            or not ctr["rediscoveries"]):
        raise AssertionError(
            f"rolling-restart drill: counters "
            f"{ {k: v for k, v in ctr.items() if v} }, final loss {drilled} "
            f"against {base}, restarts {restarts}")
    log(f"(d) remote_ppi_drill: {steps} steps in {wall:.2f} s, shards "
        f"drained and restarted (step, shard, seconds down, load s): "
        f"{restarts}; calls_failed 0, rpc_errors 0, retries "
        f"{ctr['retries']}, dials_failed {ctr['dials_failed']}, "
        f"rediscoveries {ctr['rediscoveries']}, failovers "
        f"{ctr['failovers']}; final loss (last 5) {drilled:.5f} against "
        f"(c)'s {base:.5f} (tolerance {DRILL_LOSS_TOL}); launches "
        f"{launches} (card: {smi})")
    return {"launches": launches}


def phase_remote(work: str, seed: int, smi: str, device: str = "cuda",
                 ppi: dict | None = None) -> dict:
    """Remote and shared graphs over phase 5's ppi files (phase 8 of the
    module docstring)."""
    log("== phase 8: remote")
    from euler_tpu_torch import datasets
    from euler_tpu_torch.graph import Graph, sampling_kernels

    ppi = ppi or datasets.PPI
    max_id = ppi["num_nodes"] - 1
    data_dir = os.path.join(work, "ppi")
    reg = os.path.join(work, "reg")
    os.makedirs(reg)
    runs = {}
    shards = {}
    try:
        # (a) two shard processes on a flat-file registry
        shards.update({s: Shard(s, data_dir, reg)
                       for s in range(REMOTE_SHARDS)})
        ups = [shards[s].wait_up() for s in range(REMOTE_SHARDS)]
        log("(a) shards " + ", ".join(
            f"{s}: loaded in {ld:.3f} s, serving {up:.2f} s after launch"
            for s, (ld, up) in enumerate(ups))
            + f"; registry {sorted(os.listdir(reg))}")
        # (b) seeded ids through the remote client against the local engine
        local = Graph(directory=data_dir)
        remote = Graph(mode="remote", registry=reg)
        ids = np.random.default_rng(seed).integers(0, max_id + 1,
                                                   REMOTE_CHECK_IDS)
        t0 = time.perf_counter()
        checks = {
            "counts": lambda g: (g.num_nodes, g.num_edges,
                                 g.type_weight_sums()),
            "node_types": lambda g: g.node_types(ids),
            "full_neighbors": lambda g: g.get_full_neighbor(ids, [0]),
            "dense_features": lambda g: g.get_dense_feature(
                ids, [0, 1], [PPI_LABEL_DIM, PPI_FEATURE_DIM]),
            "top_k": lambda g: g.get_top_k_neighbor(ids, [0], 10),
        }
        for name, read in checks.items():
            a, b = read(remote), read(local)
            flat = [(x, y) for x, y in zip(a, b)] if isinstance(a, tuple) \
                else [(a, b)]
            if not all(np.array_equal(np.asarray(x), np.asarray(y))
                       for x, y in flat):
                raise AssertionError(f"remote {name} differ from local")
        log(f"(b) {REMOTE_CHECK_IDS} seeded ids over the wire equal the "
            f"local engine's: {', '.join(checks)} "
            f"({time.perf_counter() - t0:.3f} s; {remote.num_shards} shards, "
            f"{remote.num_partitions} partitions, placement "
            f"{remote.has_placement})")
        remote.close()
        local.close()
        # (c) python -m euler_tpu_torch --graph_mode remote
        r = run_loop_path("remote_ppi", data_dir,
                          os.path.join(work, "m_remote"),
                          ["--graph_mode", "remote", "--registry", reg],
                          seed, smi, device, max_id)
        wire, steps = r["wire"], r["steps"]
        fan = wire["fanout"]
        on_wire = sum(v["ids_on_wire"] for v in fan.values())
        c = wire["counters"]
        log(f"(c) remote_ppi: step {r['step_ms']:.4f} ms (median of steps "
            f"11-{steps}), input stall {r['stall_ms']:.4f} ms a step, "
            f"{r['stalled']} of {steps} steps waited over 1 ms, the "
            f"pipeline's wait on a step's fanout {r['sample_ms']:.4f} ms; "
            f"ids on the wire {on_wire / steps:.1f} a step (client fan-out "
            f"{fan}); feature cache hits {c['cache_hits']} misses "
            f"{c['cache_misses']}, neighbour cache hits "
            f"{c['nbr_cache_hits']} misses {c['nbr_cache_misses']}, ids "
            f"deduped {c['ids_deduped']}, async submits "
            f"{c['async_submits']}, calls_failed {c['calls_failed']}; peak "
            f"{r['peak_bytes']} B; eval {r['eval']} (card: {smi})")
        if r["launches"] != {"sample_fanout2": 0, "sample_neighbor": 0} \
                or c["calls_failed"] or not c["async_submits"]:
            raise AssertionError(f"remote_ppi: launches {r['launches']}, "
                                 f"counters {c}")
        graph = Graph(mode="remote", registry=reg)
        log("(c) remote train.train profiled over steps 11-20: "
            + profile_host_steps(
                r["model"], graph,
                lambda step: graph.sample_node(PPI_BATCH, 0), seed, device)
            + f" (card: {smi})")
        local = Graph(directory=data_dir)
        log("(c) a batch's parts, host clock, median of "
            f"{BREAKDOWN_RUNS}: " + "; ".join(
                f"{name}: " + batch_parts(r["model"], g, seed)
                for name, g in (("remote", graph), ("local engine", local))))
        local.close()
        graph.close()
        runs["remote_ppi"] = {k: r[k] for k in ("launches", "steps",
                                                "step_ms", "peak_bytes")}
        # (d) the rolling-restart drill
        runs["remote_ppi_drill"] = rolling_drill(
            data_dir, reg, shards, seed, smi, device, max_id, r["losses"])
        # (e) shared mode in one process, a tcp:// registry hosted by it
        sh = run_loop_path(
            "shared_ppi", data_dir, os.path.join(work, "m_shared"),
            ["--graph_mode", "shared", "--registry",
             f"tcp://127.0.0.1:{free_port()}"], seed, smi, device, max_id)
        if sh["launches"] != {"sample_fanout2": 0, "sample_neighbor": 0} \
                or sh["wire"]["counters"]["calls_failed"]:
            raise AssertionError(f"shared_ppi: launches {sh['launches']}, "
                                 f"counters {sh['wire']['counters']}")
        runs["shared_ppi"] = {k: sh[k] for k in ("launches", "steps",
                                                 "step_ms", "peak_bytes")}
        # (f) serving over the remote graph, and a delta under it
        runs["serve_remote"] = serve_remote(
            data_dir, os.path.join(work, "m_remote"), reg, seed, smi, device,
            max_id, work)
        for s in range(REMOTE_SHARDS):
            rc = shards[s].drain()
            if rc != 0:
                raise AssertionError(f"shard {s} exited {rc} on SIGTERM")
    finally:
        for sh_ in shards.values():
            sh_.kill()
    moved = {p: r["launches"] for p, r in runs.items()
             if any(r["launches"].values())}
    if moved:
        raise AssertionError(f"phase 8 paths launched kernels: {moved}")
    return runs


# phase 9 (training's observability plane): the metrics line period, the
# steps torch.profiler captures (train.train's profile_steps), the
# slack a kernel's device event may lie outside its step's device phase,
# the fence drill's --telemetry values in turn and the child process's
# device allocation
OBS_METRICS_EVERY = 10
OBS_PROFILE_STEPS = (10, 20)
OBS_WINDOW_SLACK_US = 1000
OBS_FENCE_ORDER = ("1", "0", "0", "1")
OBS_CHILD_BYTES = 64 << 20
OBS_PLANES = ["--telemetry", "1", "--devprof", "1", "--blackbox", "1"]


def phase_rows(hists: dict) -> dict:
    """{phase: {count, mean_ms, p50_ms, p99_ms}} of the step phases
    recorded, in ``telemetry.PHASES`` order."""
    from euler_tpu_torch import telemetry as T

    rows = {}
    for name in T.PHASES:
        h = hists.get(name)
        if not h or not h["count"]:
            continue
        pct = T.percentiles(h, (50, 99))
        rows[name] = {"count": h["count"],
                      "mean_ms": round(h["sum_us"] / h["count"] / 1e3, 4),
                      "p50_ms": round(pct[50] / 1e3, 4),
                      "p99_ms": round(pct[99] / 1e3, 4)}
    return rows


def observed_run(argv, device: str, steps: int, reset: bool = True):
    """``run_loop.main(argv)`` with the launch counts and (``reset``) the
    telemetry set to 0 just before and read just after; B1 must launch
    once a step. Returns the launches, the per-step host times of
    ``step_hook`` and the phase rows."""
    from euler_tpu_torch import devprof
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch import train as train_lib
    from euler_tpu_torch.graph import native, sampling_kernels

    stamps = []
    real_train = train_lib.train

    def stamped(*a, **k):
        hook = k.get("step_hook")

        def step_hook(step):
            stamps.append(time.perf_counter())
            if hook is not None:
                hook(step)

        k["step_hook"] = step_hook
        return real_train(*a, **k)

    if reset:
        native.reset_counters()
        T.telemetry_reset()
        devprof.devprof_reset()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    train_lib.train = stamped
    try:
        run_loop_main(argv, device)
    finally:
        train_lib.train = real_train
    launches = dict(sampling_kernels.launches)
    want = steps if "--device_sampling" in argv else 0
    if launches != {"sample_fanout2": want, "sample_neighbor": 0}:
        raise AssertionError(f"{argv}: launches {launches}, want B1 {want}")
    if len(stamps) != steps:
        raise AssertionError(f"{len(stamps)} steps of {steps}")
    return launches, np.diff(stamps) * 1e3, phase_rows(T.phase_hists())


def check_trace(trace_file: str, steps: int, device: str) -> dict:
    """The merged trace of (a): valid, a ``step`` slice a step, one B1
    kernel event a profiled step, each inside its step's ``device`` phase
    window (give or take OBS_WINDOW_SLACK_US). Returns the profiled
    steps' device lanes a step (kernels, device events, device ms) over
    their ``step`` slices (wall ms a step)."""
    from euler_tpu_torch import trace as TR

    with open(trace_file) as f:
        trace = json.load(f)
    events = TR.validate_chrome_trace(trace)
    phases = [e for e in events if e.get("cat") == "phase"]
    by_name = {}
    for e in phases:
        by_name.setdefault(e["name"], {})[e["args"]["step"]] = e
    if sorted(by_name.get("step", {})) != list(range(steps)):
        raise AssertionError(f"trace: step slices for "
                             f"{sorted(by_name.get('step', {}))[:5]}...")
    dev_events = [e for e in events if e.get("cat") == "device"]
    b1 = [e for e in dev_events if "fanout2_kernel" in e["name"]]
    profiled = range(*OBS_PROFILE_STEPS)
    if device != "cuda":  # a CPU rehearsal: the capture has no device lane
        b1 = [{"ts": by_name["device"][s]["ts"], "dur": 0} for s in profiled]
    if len(b1) != len(profiled):
        raise AssertionError(f"trace: {len(b1)} B1 events over "
                             f"{len(profiled)} profiled steps")
    for step in profiled:
        d = by_name["device"][step]
        lo = d["ts"] - OBS_WINDOW_SLACK_US
        hi = d["ts"] + d["dur"] + OBS_WINDOW_SLACK_US
        if not any(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in b1):
            raise AssertionError(
                f"trace: no B1 event inside step {step}'s device phase "
                f"[{lo}, {hi}] us: {[(e['ts'], e['dur']) for e in b1]}")
    slices = [by_name["step"][s] for s in profiled]
    t0 = min(e["ts"] for e in slices)
    t1 = max(e["ts"] + e["dur"] for e in slices)
    window = [e for e in dev_events if t0 <= e["ts"] <= t1]
    n = len(profiled)
    # the unprofiled steps after the warm-up: the wall the busy share is
    # taken over (the profiler slows the host it records)
    plain = [by_name["step"][s]["dur"] for s in range(OBS_PROFILE_STEPS[0],
                                                       steps)
             if s not in profiled]
    return {"events": len(events), "b1_events": len(b1),
            "kernels_a_step": sum(e["args"]["kind"] == "kernel"
                                  for e in window) / n,
            "device_events_a_step": len(window) / n,
            "device_ms_a_step": sum(e["dur"] for e in window) / n / 1e3,
            "wall_ms_a_step": (t1 - t0) / n / 1e3,
            "step_ms_unprofiled": statistics.median(plain) / 1e3}


SEGV_CHILD = r"""
import os, signal, sys, time
import torch
from euler_tpu_torch import blackbox, devprof
held = torch.empty(int(sys.argv[2]), dtype=torch.uint8, device="cuda")
devprof.install(device="cuda")
blackbox.install(sys.argv[1], sample_ms=50)
n, buffers = devprof.sample_device_mem()
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "euler_tpu")]
print(f"allocated {n} buffers {buffers} bad {bad}", flush=True)
time.sleep(0.5)  # the blackbox sampler takes the gauge into its ring
os.kill(os.getpid(), signal.SIGSEGV)
"""


def segv_child(pm_dir: str, device: str) -> tuple:
    """A child process that imports only the port, holds
    OBS_CHILD_BYTES on the card, arms the postmortem and dies by SIGSEGV;
    returns its exit code, its output and the parsed postmortem."""
    from euler_tpu_torch import blackbox

    root = os.path.dirname(os.path.abspath(__file__))
    code = SEGV_CHILD if device == "cuda" else SEGV_CHILD.replace(
        '"cuda"', '"cpu"')
    proc = subprocess.run(
        [sys.executable, "-c", code, pm_dir, str(OBS_CHILD_BYTES)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=120)
    dumps = blackbox.postmortem_read(pm_dir)
    if proc.returncode != -signal.SIGSEGV or len(dumps) != 1:
        raise AssertionError(
            f"(e) the child exited {proc.returncode} with {len(dumps)} "
            f"postmortems:\n{proc.stdout}\n{proc.stderr[-3000:]}")
    return proc, dumps[0]


def phase_observe(work: str, seed: int, smi: str, device: str = "cuda",
                  max_id: int = 56943) -> dict:
    """Training's observability plane on phase 5's ppi files and phase 6's
    checkpoint: (a) run_loop_device with every plane on for an epoch (B1
    once a step; each phase counted once a step; a metrics line every
    OBS_METRICS_EVERY steps; the merged trace valid, B1's kernel inside
    each profiled step's device phase; the memory gauge equal to
    ``torch.cuda.memory_allocated`` at the sample); (b) the step fence's
    cost: the median host step of steps 11-111 with ``--telemetry`` 1 and
    0; (c) run_loop_host's step split into its phases; (d) serve_ppi's
    ``stats()["devprof"]``: one capture, no recompile, and a strict
    bucket's drill raising ``devprof.RecompileError``; (e) a port-only
    child killed by SIGSEGV leaves a postmortem with the card's memory
    in its resource ring; (f) the console's ``stats phases``, ``stats
    devprof`` and ``nb`` on the ppi files."""
    log("== phase 9: training's observability plane")
    import io

    from euler_tpu_torch import console, devprof, run_loop, serve
    from euler_tpu_torch import telemetry as T
    from euler_tpu_torch.graph import native, sampling_kernels

    data_dir = os.path.join(work, "ppi")
    obs = os.path.join(work, "obs")
    steps = (max_id + 1) // PPI_BATCH
    base = ["--data_dir", data_dir, "--max_id", str(max_id), "--seed",
            str(seed), *RUN_LOOP_ARGS]
    runs = {}
    # (a) every plane on
    argv = base + ["--model_dir", os.path.join(obs, "m_planes"),
                   "--device_sampling", "1", *OBS_PLANES,
                   "--metrics_every", str(OBS_METRICS_EVERY),
                   "--metrics_file", os.path.join(obs, "metrics.jsonl"),
                   "--trace_file", os.path.join(obs, "trace.json"),
                   "--profile_dir", os.path.join(obs, "profile"),
                   "--postmortem_dir", os.path.join(obs, "postmortems")]
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    launches, _, rows = observed_run(argv, device, steps)
    wall = time.perf_counter() - t0
    runs["run_loop_device_planes"] = {"launches": launches}
    for name in ("input_stall", "sample", "h2d", "device", "host", "step"):
        if rows.get(name, {}).get("count") != steps:
            raise AssertionError(f"(a) phase {name}: {rows.get(name)}, "
                                 f"want {steps} samples")
    with open(os.path.join(obs, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    if [x["step"] for x in lines] != list(
            range(OBS_METRICS_EVERY, steps + 1, OBS_METRICS_EVERY)):
        raise AssertionError(f"(a) metrics lines at steps "
                             f"{[x['step'] for x in lines]}")
    tr = check_trace(os.path.join(obs, "trace.json"), steps, device)
    if os.listdir(os.path.join(obs, "postmortems")):
        raise AssertionError("(a) a postmortem was written by a clean run")
    nbytes, buffers = devprof.sample_device_mem()
    res = T.telemetry_json()["resource"]
    alloc = (torch.cuda.memory_allocated() if device == "cuda"
             else nbytes)
    if not nbytes == res["device_mem_bytes"] == alloc:
        raise AssertionError(f"(a) memory gauge {res['device_mem_bytes']}, "
                             f"sample {nbytes}, memory_allocated {alloc}")
    busy = tr["device_ms_a_step"] / tr["step_ms_unprofiled"]
    log(f"(a) run_loop_device with every plane on: {wall:.2f} s, {steps} "
        f"steps, launches {launches}; phases (ms) {rows}; "
        f"{len(lines)} metrics lines, the last {lines[-1]}; trace "
        f"{tr['events']} events, B1 inside each of the "
        f"{OBS_PROFILE_STEPS[1] - OBS_PROFILE_STEPS[0]} profiled steps' "
        f"device phase (+-{OBS_WINDOW_SLACK_US} us); profiled steps "
        f"{OBS_PROFILE_STEPS[0]}-{OBS_PROFILE_STEPS[1] - 1}: device "
        f"{tr['device_ms_a_step']:.4f} ms a step over "
        f"{tr['device_events_a_step']:.1f} device events "
        f"({tr['kernels_a_step']:.1f} kernels) a step, wall "
        f"{tr['wall_ms_a_step']:.4f} ms a step under the profiler; busy "
        f"share {busy:.4f} of the unprofiled steps' median "
        f"{tr['step_ms_unprofiled']:.4f} ms (steps "
        f"{OBS_PROFILE_STEPS[1]}-{steps - 1}); "
        f"memory gauge {res['device_mem_bytes']} B = memory_allocated, "
        f"peak gauge {res['device_mem_peak_bytes']} B, {buffers} live "
        f"blocks, reserved {devprof.last_device_mem().get('reserved')} B; "
        f"compiles {devprof.compile_summary()['compiles']} (card: {smi})")
    # (b) the fence's cost: one window a run, so only the fence syncs
    fence = {"1": [], "0": []}
    for i, tel in enumerate(OBS_FENCE_ORDER):
        argv = base + ["--model_dir", os.path.join(obs, f"m_fence{i}"),
                       "--device_sampling", "1", "--telemetry", tel,
                       "--log_steps", str(10 * steps)]
        name = f"run_loop_device_telemetry{tel}_{i}"
        launches, step_ms, _ = observed_run(argv, device, steps)
        runs[name] = {"launches": launches}
        fence[tel].append(statistics.median(step_ms[10:]))
    T.set_telemetry(True)
    log(f"(b) the step fence: median host step of steps 11-{steps}, "
        f"--telemetry 1 (fenced) {[round(float(x), 4) for x in fence['1']]}"
        f" ms, --telemetry 0 (unfenced) "
        f"{[round(float(x), 4) for x in fence['0']]} "
        f"ms (runs in the order {OBS_FENCE_ORDER}; card: {smi})")
    # (c) run_loop_host's step, phase by phase
    argv = base + ["--model_dir", os.path.join(obs, "m_host"), *OBS_PLANES]
    launches, step_ms, host_rows = observed_run(argv, device, steps)
    runs["run_loop_host_planes"] = {"launches": launches}
    log(f"(c) run_loop_host by phase (ms): {host_rows}; median host step "
        f"{statistics.median(step_ms[10:]):.4f} ms (card: {smi})")
    # (f) the console on the ppi files
    con = console.Console()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        con.execute(f'con "directory={data_dir}"')
        con.execute("stats phases")
        con.execute("stats devprof")
        con.execute('nb "0, 1, 2" "0"')
    con.graph.close()
    out = buf.getvalue().splitlines()
    if not (out[0].startswith(f"connected: {max_id + 1} nodes") and
            [x.split(":")[0] for x in out[-3:]] == ["node 0", "node 1",
                                                    "node 2"]
            and any(x.startswith("devprof on") for x in out)):
        raise AssertionError("(f) console:\n" + "\n".join(out))
    log(f"(f) python -m euler_tpu_torch.console on the ppi files (card: "
        f"{smi}):\n  " + "\n  ".join(out))
    # (d) serving's device plane
    argv = base + ["--model_dir", os.path.join(work, "m2"), "--serve_port",
                   "0", "--serve_max_batch", str(SERVE_MAX_BATCH)]
    args = run_loop.define_flags().parse_args(argv)
    args.mode = "evaluate"
    graph, _ = run_loop.build_graph(args)
    model = run_loop.build_model(args, graph)
    native.reset_counters()
    T.telemetry_reset()
    devprof.devprof_reset()
    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    server = serve.build_server(model, graph, args, device)
    try:
        ids = np.random.default_rng(seed).integers(0, max_id + 1, 200)
        for off in range(0, len(ids), 40):
            server._embed_unique(np.unique(ids[off:off + 40]))
        dev = server.stats()["devprof"]
        if (dev["captures"], dev["recaptures"], dev["recompiles"],
                dev["serve_recompiles"]) != (1, 0, 0, 0) or dev[
                "compile_events"] != (1 if device == "cuda" else 0):
            raise AssertionError(f"(d) serve_ppi devprof {dev}")
        strict = serve.EmbedServer(model, graph, server._state,
                                   max_batch=SERVE_MAX_BATCH,
                                   strict_bucket=True)
        blk = strict._block(int(ids[0]))
        want = strict._forward([blk])
        other = dict(blk, labels=np.zeros(
            (1, blk["labels"].shape[1] + 1), blk["labels"].dtype))
        try:
            strict._forward([other])
            raise AssertionError("(d) the strict bucket took a changed "
                                 "layout")
        except devprof.RecompileError as e:
            drill = str(e)
        if not np.array_equal(strict._forward([blk]), want) or (
                strict._captures, strict._recaptures) != (1, 0):
            raise AssertionError("(d) the strict bucket lost its capture")
        led = devprof.recompile_ledger()
        ctr = native.counters()
        log(f"(d) serve_ppi stats()['devprof'] after 200 ids: {dev}; the "
            f"strict drill raised RecompileError ({drill}), kept its one "
            f"capture, ledger {[(e['fn'], e['diff']) for e in led]}, "
            f"serve_recompiles {ctr['serve_recompiles']}, device_recompiles "
            f"{ctr['device_recompiles']}; launches "
            f"{dict(sampling_kernels.launches)} (card: {smi})")
        runs["serve_ppi_devprof"] = {"launches": dict(
            sampling_kernels.launches)}
    finally:
        server.close()
        graph.close()
    # (e) a port-only child killed by SIGSEGV
    t0 = time.perf_counter()
    proc, doc = segv_child(os.path.join(obs, "segv"), device)
    said = dict(zip(proc.stdout.split()[::2], proc.stdout.split()[1::2]))
    hist = doc["resource_history"]
    if (not hist or hist[-1]["device_mem_bytes"] != int(said["allocated"])
            or said["bad"] != "[]" or (device == "cuda" and int(
                said["allocated"]) < OBS_CHILD_BYTES)):
        raise AssertionError(f"(e) postmortem resource {hist[-1:]}, child "
                             f"said {proc.stdout!r}")
    log(f"(e) child pid {doc['pid']} died by {doc['signal_name']} (exit "
        f"{proc.returncode}) in {time.perf_counter() - t0:.2f} s; its "
        f"postmortem parses: {len(doc['rings'])} rings, "
        f"{len(doc['backtrace_symbols'])} frames, resource ring "
        f"{len(hist)} samples, the last {hist[-1]} (memory_allocated in the "
        f"child {said['allocated']} B; card: {smi})")
    return runs


# phase 11 (multi-device): the mesh paths
MESH_NCCL_STEPS = 20
MESH_DP_STEPS = 50
MESH_UNSUP_STEPS = 10
MESH_MP_STEPS = 10
MESH_LOSS_RTOL = 1e-5
MESH_TIMEOUT_S = 300
MESH_REDUCE_RUNS = 20


def mesh_sage(max_id: int, device_sampling: bool = True,
              dim: int = PPI_DIM, **extra):
    """Phase 4's ppi model (``SupervisedGraphSage`` at full width, as
    run_loop's graphsage_supervised), over device tables, drawn on the
    card or host-sampled; ``extra`` are more of its options."""
    from euler_tpu_torch.models import SupervisedGraphSage

    return SupervisedGraphSage(
        label_idx=0, label_dim=PPI_LABEL_DIM, metapath=[[0], [0]],
        fanouts=list(PPI_FANOUTS), dim=dim, feature_idx=1,
        feature_dim=PPI_FEATURE_DIM, max_id=max_id, device_features=True,
        device_sampling=device_sampling, **extra)


def mesh_unsup(max_id: int, dim: int = PPI_DIM, **extra):
    """Phase 4's unsupervised ``GraphSage`` (run_loop --model graphsage's
    defaults), drawn on the card; ``extra`` are more of its options."""
    from euler_tpu_torch.models import GraphSage

    return GraphSage(
        node_type=0, edge_type=[0], max_id=max_id, metapath=[[0], [0]],
        fanouts=list(PPI_FANOUTS), dim=dim, num_negs=SAGE_NEGS,
        feature_idx=1, feature_dim=PPI_FEATURE_DIM, aggregator="mean",
        concat=True, xent_loss=True, device_features=True,
        device_sampling=True, **extra)


def step_roots(seed: int, step: int, n: int, batch: int) -> np.ndarray:
    """Step ``step``'s roots, a function of the step alone (prefetch
    workers may build steps in any order)."""
    return np.random.default_rng([seed, step]).integers(0, n, batch)


def params_digest(module) -> str:
    import hashlib

    h = hashlib.sha256()
    for k, v in sorted(module.state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def mesh_rank(rank: int, n: int, addr: str, job_path: str,
              out_path: str, device) -> None:
    """One of phase 11's two spawned ranks on the one card: (b) data 2,
    then (c) model 2. Writes its numbers to ``out_path % rank``."""
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph
    from euler_tpu_torch.models import base
    from euler_tpu_torch.parallel import mesh as mesh_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    job = torch.load(job_path, weights_only=False)
    backend, dev = mesh_mod.init_distributed(addr, n, rank, device)
    res = {"backend": backend, "device": str(dev), "rank": rank}
    batch, dim = job["batch_size"], job["dim"]
    try:
        graph = MemoryGraph(**build_synthetic(**job["ppi"]))
        max_id = graph.max_node_id
        opt = train.get_optimizer("adam", PPI_LR)

        def one_step(mesh):
            """The first step on the parent's host batch (B1's picks of
            the global batch), from the parent's parameters."""
            m = mesh_sage(max_id, device_sampling=False, dim=dim)
            st = m.init_state(graph, opt, device=dev, seed=job["seed"])
            st["module"].load_state_dict(job["params"])
            st = mesh_mod.shard_state(st, mesh)
            local = mesh_mod.shard_batch(job["batch"], mesh, batch)
            loss, _ = m.make_train_step(mesh)(st, base.to_device(local, dev))
            return float(loss), st

        # (b) data 2
        mesh = mesh_mod.make_mesh(n, 1)
        res["b_loss1"], _ = one_step(mesh)
        model = mesh_sage(max_id, dim=dim)
        device_graph.set_kernel_mesh(mesh)
        per = batch // mesh.shape["data"]
        mine = mesh.batch_slice(batch)
        try:
            st = model.init_state(graph, opt, device=dev, seed=job["seed"],
                                  mesh=mesh)
            st["module"].load_state_dict(job["params"])
            for k in sampling_kernels.launches:
                sampling_kernels.launches[k] = 0
            for k in sampling_kernels.sharded_launches:
                sampling_kernels.sharded_launches[k] = 0
            t0 = time.perf_counter()
            st, hist = train.train(
                model, graph,
                lambda s: step_roots(job["seed"], s, max_id + 1,
                                     batch)[mine],
                MESH_DP_STEPS, mesh=mesh, log_every=10, seed=job["seed"],
                state=st, device=dev, prefetch_threads=1)
            sync(dev)
            res["b_wall_s"] = time.perf_counter() - t0
            res["b_launches"] = {**sampling_kernels.launches,
                                 **sampling_kernels.sharded_launches}
            res["b_losses"] = [h["loss"] for h in hist]
            res["b_step_ms"] = [1e3 / h["steps_per_sec"] for h in hist]
            res["b_digest"] = params_digest(st["module"])
            grads = [p.grad for p in st["module"].parameters()]
            res["b_reduce_bytes"] = sum(g.numel() * g.element_size()
                                        for g in grads)
            times = []
            for _ in range(MESH_REDUCE_RUNS):
                sync(dev)
                t1 = time.perf_counter()
                mesh.reduce_grads([g.clone() for g in grads], 1.0)
                sync(dev)
                times.append((time.perf_counter() - t1) * 1e3)
            res["b_reduce_ms"] = statistics.median(times)
            # the rank's B1 at its folded words against the plain version
            adj = st["consts"]["adj"][model.adj_key([0])]
            roots = torch.as_tensor(
                step_roots(job["seed"], 999, max_id + 1,
                           batch)[mine].astype(np.int32), device=dev)
            words = device_graph.seed_words(job["seed"] + 77)
            h1, h2 = sampling_kernels.sample_fanout2_sharded(
                adj, adj, roots, words, *PPI_FANOUTS, mesh)
            p1, p2 = sampling_kernels.sample_fanout2_reference(
                adj, adj, roots, sampling_kernels.folded_words(
                    words, mesh.data_rank), *PPI_FANOUTS)
            res["b_b1_err"] = max(int((h1 - p1).abs().max()),
                                  int((h2 - p2).abs().max()))
            res["b_b1_roots"] = per
            # the unsupervised GraphSage: B2 (its positives) per rank
            unsup = mesh_unsup(max_id, dim)
            for k in sampling_kernels.launches:
                sampling_kernels.launches[k] = 0
            for k in sampling_kernels.sharded_launches:
                sampling_kernels.sharded_launches[k] = 0
            _, uh = train.train(
                unsup, graph,
                lambda s: step_roots(job["seed"] + 1, s, max_id + 1,
                                     batch)[mine],
                MESH_UNSUP_STEPS, mesh=mesh, log_every=MESH_UNSUP_STEPS,
                seed=job["seed"], device=dev, prefetch_threads=1)
            res["b_unsup_launches"] = {**sampling_kernels.launches,
                                       **sampling_kernels.sharded_launches}
            res["b_unsup_loss"] = uh[-1]["loss"]
        finally:
            device_graph.set_kernel_mesh(None)

        # (c) model 2
        mesh = mesh_mod.make_mesh(n, 2)
        res["c_loss1"], st = one_step(mesh)
        feats = st["consts"]["features"]
        res["c_shard_rows"] = [feats.local.shape[0], feats.shape[0]]
        res["c_shard_bytes"] = sum(
            x.local.numel() * x.local.element_size()
            for _, x in mesh_mod.table_leaves(st))
        model = mesh_sage(max_id, dim=dim)
        device_graph.set_kernel_mesh(mesh)
        try:
            for k in sampling_kernels.launches:
                sampling_kernels.launches[k] = 0
            for k in sampling_kernels.sharded_launches:
                sampling_kernels.sharded_launches[k] = 0
            st, hist = train.train(
                model, graph,
                lambda s: step_roots(job["seed"], s, max_id + 1, batch),
                MESH_MP_STEPS, mesh=mesh, log_every=MESH_MP_STEPS,
                seed=job["seed"], device=dev, prefetch_threads=1)
            res["c_launches"] = {**sampling_kernels.launches,
                                 **sampling_kernels.sharded_launches}
            res["c_loss"] = hist[-1]["loss"]
            res["c_digest"] = params_digest(st["module"])
        finally:
            device_graph.set_kernel_mesh(None)
    finally:
        mesh_mod.shutdown_distributed()
    torch.save(res, out_path % rank)


def mesh_cli(work: str, data_dir: str, max_id: int, device: str) -> dict:
    """(d): two processes of ``python -m euler_tpu_torch --graph_mode
    shared`` joined over TCP, each serving its shard of the ppi files,
    through train, then evaluate and save_embedding (those two at once,
    each pair on its own registry and coordinator). Returns each mode's
    output lines by process."""
    root = os.path.dirname(os.path.abspath(__file__))
    model_dir = os.path.join(work, "m_mesh")
    env = dict(os.environ, PYTHONPATH=root)
    out = {"seconds": {}}

    def start(mode):
        reg_port, coord_port = free_port(), free_port()
        procs = []
        for pid in range(2):
            argv = [sys.executable, "-m", "euler_tpu_torch",
                    "--data_dir", data_dir, "--model_dir", model_dir,
                    "--max_id", str(max_id), "--seed", "0",
                    *RUN_LOOP_ARGS, "--mode", mode,
                    "--graph_mode", "shared",
                    "--registry", f"tcp://127.0.0.1:{reg_port}",
                    "--coordinator_addr", f"127.0.0.1:{coord_port}",
                    "--num_processes", "2", "--process_id", str(pid)]
            if device == "cpu":  # a rehearsal: the CLI runs on the card
                argv = [sys.executable, "-c",
                        "import sys; from euler_tpu_torch import run_loop; "
                        "sys.exit(run_loop.main(sys.argv[1:], "
                        "device='cpu'))", *argv[3:]]
            procs.append(subprocess.Popen(
                argv, cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        return procs

    for modes in (("train",), ("evaluate", "save_embedding")):
        t0 = time.perf_counter()
        running = {mode: start(mode) for mode in modes}
        try:
            for mode, procs in running.items():
                outs = [p.communicate(timeout=MESH_TIMEOUT_S)[0]
                        for p in procs]
                out["seconds"][mode] = round(time.perf_counter() - t0, 2)
                for pid, (p, text) in enumerate(zip(procs, outs)):
                    if p.returncode != 0:
                        raise AssertionError(
                            f"(d) {mode} process {pid} exited "
                            f"{p.returncode}:\n{text[-3000:]}")
                out[mode] = outs
        finally:
            for procs in running.values():
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait(10)
    return out


def phase_mesh(work: str, seed: int, smi: str, device: str = "cuda",
               ppi=None) -> tuple:
    """Phase 11: multi-device training over ``parallel.mesh``. Returns the
    paths' launches and the two sharded routes' numbers."""
    log("== phase 11: multi-device")
    from euler_tpu_torch import train
    from euler_tpu_torch.datasets import PPI, build_synthetic
    from euler_tpu_torch.graph import MemoryGraph, sampling_kernels
    from euler_tpu_torch.graph import device as device_graph
    from euler_tpu_torch.parallel import mesh as mesh_mod

    ppi = dict(PPI) if ppi is None else ppi
    t0 = time.perf_counter()
    graph = MemoryGraph(**build_synthetic(**ppi))
    max_id = graph.max_node_id
    opt = train.get_optimizer("adam", PPI_LR)
    runs = {}

    def reset():
        for d in (sampling_kernels.launches,
                  sampling_kernels.sharded_launches):
            for k in d:
                d[k] = 0

    def counts():
        return {**sampling_kernels.launches,
                **sampling_kernels.sharded_launches}

    # (a) one rank over NCCL against the unsharded port
    model = mesh_sage(max_id, dim=PPI_DIM)
    losses = {}
    for name in ("unsharded", "mesh"):
        mesh = None
        if name == "mesh":
            backend, _ = mesh_mod.init_distributed(
                f"127.0.0.1:{free_port()}", 1, 0, device)
            mesh = mesh_mod.make_mesh(1, 1)
            if device == "cuda" and backend != "nccl":
                raise AssertionError(f"(a) one rank on the card over "
                                     f"{backend}, not nccl")
        reset()
        try:
            t1 = time.perf_counter()
            _, hist = train.train(
                model, graph,
                lambda s: step_roots(seed, s, max_id + 1, PPI_BATCH),
                MESH_NCCL_STEPS, mesh=mesh, log_every=1, seed=seed,
                device=device, prefetch_threads=1)
            sync(device)
            wall = time.perf_counter() - t1
        finally:
            if mesh is not None:
                mesh_mod.shutdown_distributed()
        losses[name] = [h["loss"] for h in hist]
        if name == "mesh":
            runs["mesh_nccl1"] = {"launches": counts()}
            log(f"(a) mesh_nccl1: backend {backend}, world 1, device "
                f"{device}: {MESH_NCCL_STEPS} steps in {wall:.2f} s, "
                f"launches {counts()} (card: {smi})")
    if losses["mesh"] != losses["unsharded"]:
        raise AssertionError(f"(a) one NCCL rank's losses {losses['mesh']} "
                             f"differ from the unsharded {losses['unsharded']}")
    log(f"(a) losses bit-equal to the unsharded port's over "
        f"{MESH_NCCL_STEPS} steps: {losses['mesh'][0]:.6f} -> "
        f"{losses['mesh'][-1]:.6f}")

    # (b), (c): two spawned ranks on the one card
    dev = torch.device(device)
    params_model = mesh_sage(max_id, device_sampling=False,
                             dim=PPI_DIM)
    st0 = params_model.init_state(graph, opt, device=dev, seed=seed)
    roots = step_roots(seed, 0, max_id + 1, PPI_BATCH).astype(np.int32)
    adj = device_graph.tensors(device_graph.build_adjacency(graph, [0],
                                                            max_id), dev)
    reset()
    h1, h2 = sampling_kernels.sample_fanout2(
        adj, adj, torch.as_tensor(roots, device=dev),
        device_graph.seed_words(seed + 5), *PPI_FANOUTS)
    hops = [roots.astype(np.int64), h1.reshape(-1).cpu().numpy(),
            h2.reshape(-1).cpu().numpy()]
    job = {"ppi": ppi, "seed": seed, "batch_size": PPI_BATCH, "dim": PPI_DIM,
           "batch": params_model._batch_from_hops(None, hops[0], hops),
           "params": {k: v.cpu() for k, v in
                      st0["module"].state_dict().items()}}
    job_path = os.path.join(work, "mesh_job.pt")
    torch.save(job, job_path)
    out_path = os.path.join(work, "mesh_rank%d.pt")
    t1 = time.perf_counter()
    mesh_mod.launch(mesh_rank, 2, (2, f"127.0.0.1:{free_port()}", job_path,
                                   out_path, device), MESH_TIMEOUT_S)
    ranks = [torch.load(out_path % r, weights_only=False) for r in range(2)]
    log(f"(b, c) two ranks in {time.perf_counter() - t1:.2f} s (spawn, ppi "
        f"build, both paths)")
    for r in ranks:
        log(f"rank {r['rank']}: backend {r['backend']}, device {r['device']}"
            f"; (b) {MESH_DP_STEPS} steps, launches {r['b_launches']}, step "
            f"ms by window {[round(x, 3) for x in r['b_step_ms']]}, "
            f"all-reduce {r['b_reduce_ms']:.3f} ms for {r['b_reduce_bytes']} "
            f"B a step, B1 at its folded words vs plain max |diff| "
            f"{r['b_b1_err']} at [{r['b_b1_roots']}, {PPI_FANOUTS[0]}, "
            f"{PPI_FANOUTS[1]}]; unsupervised launches "
            f"{r['b_unsup_launches']}; (c) feature rows {r['c_shard_rows'][0]}"
            f" of {r['c_shard_rows'][1]}, table-shard bytes "
            f"{r['c_shard_bytes']}, launches {r['c_launches']} "
            f"(card: {smi})")
    b0, b1 = ranks
    if b0["backend"] != "gloo":
        raise AssertionError(f"two ranks on one card over {b0['backend']}")
    if b0["b_digest"] != b1["b_digest"] or b0["c_digest"] != b1["c_digest"]:
        raise AssertionError("(b, c) the ranks' parameters differ")
    if b0["b_losses"] != b1["b_losses"] or not (
            np.mean(b0["b_losses"][-2:]) < np.mean(b0["b_losses"][:2])):
        raise AssertionError(f"(b) losses {b0['b_losses']} {b1['b_losses']}")
    for r in ranks:
        if r["b_b1_err"] != 0:
            raise AssertionError(f"(b) rank {r['rank']}: B1 at its folded "
                                 "words differs from its plain version")
        for path, got, steps, b2 in (
                ("b", r["b_launches"], MESH_DP_STEPS, 0),
                ("b, unsupervised", r["b_unsup_launches"],
                 3 * MESH_UNSUP_STEPS, MESH_UNSUP_STEPS),
                ("c", r["c_launches"], MESH_MP_STEPS, 0)):
            want = {"sample_fanout2": steps, "sample_neighbor": b2,
                    "sample_fanout2_sharded": steps,
                    "sample_neighbor_sharded": b2}
            if device == "cuda" and got != want:
                raise AssertionError(f"({path}) launches {got} != {want}")
        if r["c_shard_rows"] != [(max_id + 3) // 2, 2 * ((max_id + 3) // 2)]:
            raise AssertionError(f"(c) shard rows {r['c_shard_rows']}")
        if not np.isfinite([r["b_unsup_loss"], r["c_loss"]]).all():
            raise AssertionError("(b, c) non-finite loss")
    np.testing.assert_allclose(b0["c_loss1"], b0["b_loss1"],
                               rtol=MESH_LOSS_RTOL)
    log(f"(c) the model-parallel first-step loss {b0['c_loss1']:.7f} against "
        f"the data-parallel {b0['b_loss1']:.7f} (rtol {MESH_LOSS_RTOL})")
    for r in ranks:
        runs[f"mesh_dp2/rank{r['rank']}"] = {"launches": r["b_launches"]}
        runs[f"mesh_dp2_unsup/rank{r['rank']}"] = {
            "launches": r["b_unsup_launches"]}
        runs[f"mesh_mp2/rank{r['rank']}"] = {"launches": r["c_launches"]}

    # (d) the CLI over two processes
    t1 = time.perf_counter()
    out = mesh_cli(work, os.path.join(work, "ppi"), max_id, device)
    step_line = re.compile(r"step=(\d+) loss=(\S+)")
    train_losses = [float(m.group(2)) for m in
                    step_line.finditer(out["train"][0])]
    digests = [re.search(r"export sha256 (\w+)", text).group(1)
               for text in out["save_embedding"]]
    emb = np.load(os.path.join(work, "m_mesh", "embedding.npy"))
    with open(os.path.join(work, "m_mesh", "eval.json")) as f:
        ev = json.load(f)
    log(f"(d) mesh_cli2: two shared-mode processes, train/evaluate/"
        f"save_embedding in {time.perf_counter() - t1:.2f} s "
        f"({out['seconds']} by mode, two processes each, evaluate and "
        f"save_embedding at once); "
        f"{len(train_losses)} steps, loss {train_losses[0]:.4f} -> "
        f"{train_losses[-1]:.4f}; eval {ev}; export {emb.shape}, sha256 "
        f"{digests} (card: {smi})")
    if digests[0] != digests[1] or emb.shape[0] != max_id + 1 or (
            not np.isfinite(emb).all()):
        raise AssertionError(f"(d) exports {digests}, {emb.shape}")
    if not np.mean(train_losses[-5:]) < np.mean(train_losses[:5]):
        raise AssertionError(f"(d) the loss did not fall: {train_losses}")
    # each process is fresh, so the counts it logs at exit are its run's
    launch_line = re.compile(r"kernel launches (\{.*\})")
    for mode in ("train", "evaluate", "save_embedding"):
        for pid, text in enumerate(out[mode]):
            found = launch_line.findall(text)
            if len(found) != 1:
                raise AssertionError(f"(d) {mode} process {pid} logged "
                                     f"{len(found)} launch lines")
            runs[f"mesh_cli2/{mode}/proc{pid}"] = {
                "launches": json.loads(found[0])}
    log("(d) launches by process: " + str(
        {p: r["launches"] for p, r in runs.items()
         if p.startswith("mesh_cli2/")}))

    # the sharded routes at a rank's shapes, timed in this process as the
    # second of two data rows
    mesh = mesh_mod.Mesh(2, rank=1)
    per = PPI_BATCH // 2
    r_t = torch.as_tensor(roots[per:], device=dev)
    words = device_graph.seed_words(seed + 12345)
    fold = sampling_kernels.folded_words(words, 1)
    probs = torch.diff(adj["cum"], dim=1,
                       prepend=adj["cum"].new_zeros(adj["cum"].shape[0], 1))
    f1, f2 = PPI_FANOUTS
    r1 = r_t.long()

    def hop_library(rows, count):  # torch.multinomial over gathered rows
        idx = torch.multinomial(probs[rows], count, replacement=True)
        return adj["nbr"][rows].gather(1, idx)

    routes = {}
    for name, kern, plain, library, hops in (
            ("sample_fanout2_sharded",
             lambda: sampling_kernels.sample_fanout2_sharded(
                 adj, adj, r_t, words, f1, f2, mesh),
             lambda: sampling_kernels.sample_fanout2_reference(
                 adj, adj, r_t, fold, f1, f2),
             lambda: hop_library(hop_library(r1, f1).reshape(-1).long(),
                                 f2),
             2),
            ("sample_neighbor_sharded",
             lambda: sampling_kernels.sample_neighbor_sharded(
                 adj, r_t, words, 1, mesh),
             lambda: sampling_kernels.sample_neighbor_reference(
                 adj, r_t, fold, 1),
             lambda: hop_library(r1, 1),
             1)):
        got, want = kern(), plain()
        if hops == 2:
            err = max(int((got[0] - want[0]).abs().max()),
                      int((got[1] - want[1]).abs().max()))
            b = draw_bound(adj, ((r_t, got[0]), (got[0], got[1])), per)
        else:
            err = int((got - want).abs().max())
            b = draw_bound(adj, ((r_t, got),), per)
        if err != 0:
            raise AssertionError(f"{name}: kernel differs from plain by {err}")
        if device == "cuda":
            t = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain, batch=1),
                     library_ms=cuda_ms(library))
        else:
            t = dict(ms=None, plain_ms=None, library_ms=None)
        routes[name] = dict(max_abs_err=err, bound_ms=b["bound_ms"],
                            bound_by=b["bound_by"], **t)
        log(f"{name} at a rank's [{per}, {f1 if hops == 2 else 1}"
            f"{', ' + str(f2) if hops == 2 else ''}] (data row 1 of 2): "
            f"{t}, {describe_bound(b)} (card: {smi})")
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")
    return runs, routes

# phase 12: staged data, prepared data, the other optimizers, the options
STAGED_ROOT = "chip_smoke_ppi"  # in fsspec's in-process memory:// store
OTHER_OPTIMIZERS = ("sgd", "momentum", "adagrad")
# the prepared graph: GraphSAGE-format files at PPI's size, train / val /
# test shares of the nodes and undirected links at PPI's mean degree
PREP_SPLIT = (0.8, 0.9)  # a node's uniform: train below, val, test above
PREP_TIMEOUT_S = 600


def tables_digest(consts) -> str:
    """sha256 over a (nested) consts dict's tensors: keys in sorted
    order, each tensor's dtype, shape and bytes."""
    import hashlib

    h = hashlib.sha256()

    def walk(x, path):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        else:
            t = x.detach().contiguous().reshape(-1)
            h.update(f"{path} {t.dtype} {tuple(x.shape)}".encode())
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())

    walk(consts, "")
    return h.hexdigest()


def run_loop_epoch(name: str, argv, device: str, smi: str,
                   steps: int) -> dict:
    """``run_loop.main(argv)`` in train mode for one epoch of ``steps``
    steps, the launch counts set to 0 just before and read just after:
    every step's loss finite, B1 once a step and B2 never. Prints the
    wall seconds, the losses of the first and last ten steps and the
    median step (steps 11 on, each synced by --log_steps 1)."""
    from euler_tpu_torch.graph import sampling_kernels

    for k in sampling_kernels.launches:
        sampling_kernels.launches[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    windows = run_loop_main(argv, device)
    wall = time.perf_counter() - t0
    launches = dict(sampling_kernels.launches)
    losses = np.array([w[1] for w in windows])
    if len(windows) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{name}: {len(windows)} logged steps of "
                             f"{steps}, losses {losses}")
    expect = {"sample_fanout2": steps, "sample_neighbor": 0}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches}, expected "
                             f"{expect}")
    step_ms = statistics.median(w[2] for w in windows[10:])
    head, tail = float(losses[:10].mean()), float(losses[-10:].mean())
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}: run_loop.main {wall:.2f} s, {steps} steps, launches "
        f"{launches}, loss {head:.5f} (first 10) -> {tail:.5f} (last 10), "
        f"step {step_ms:.4f} ms (median of steps 11-{steps}), "
        f"max_memory_allocated {peak} B (card: {smi})")
    return {"launches": launches, "steps": steps, "step_ms": step_ms,
            "peak_bytes": peak, "loss_head": head, "loss_tail": tail}


def write_graphsage_ppi(prefix: str, num_nodes: int, feature_dim: int,
                        label_dim: int, avg_degree: int, seed: int) -> int:
    """GraphSAGE-release-format PPI files from ``seed``: ``-G.json``
    (node-link: val/test flags by ``PREP_SPLIT``, ``num_nodes *
    avg_degree / 2`` undirected links between uniform endpoints),
    ``-feats.npy`` (normal features), ``-id_map.json`` (the identity) and
    ``-class_map.json`` (0/1 multilabel vectors). Returns their bytes."""
    rng = np.random.default_rng(seed)
    split = rng.random(num_nodes).tolist()
    nodes = [{"id": i, "val": PREP_SPLIT[0] <= u < PREP_SPLIT[1],
              "test": u >= PREP_SPLIT[1]} for i, u in enumerate(split)]
    m = num_nodes * avg_degree // 2
    ends = rng.integers(0, num_nodes, (2, m)).tolist()
    links = [{"source": a, "target": b} for a, b in zip(*ends)]
    with open(prefix + "-G.json", "w") as f:
        json.dump({"directed": False, "graph": {}, "multigraph": False,
                   "nodes": nodes, "links": links}, f)
    np.save(prefix + "-feats.npy",
            rng.standard_normal((num_nodes, feature_dim)))
    with open(prefix + "-id_map.json", "w") as f:
        json.dump({str(i): i for i in range(num_nodes)}, f)
    labels = rng.integers(0, 2, (num_nodes, label_dim)).tolist()
    with open(prefix + "-class_map.json", "w") as f:
        json.dump({str(i): row for i, row in enumerate(labels)}, f)
    return sum(os.path.getsize(prefix + suffix) for suffix in (
        "-G.json", "-feats.npy", "-id_map.json", "-class_map.json"))


def phase_staged(work: str, seed: int, smi: str, device: str = "cuda",
                 ppi: dict | None = None) -> dict:
    """Phase 12: staged data, prepared data, the other optimizers and the
    model options, on phase 5's ppi files (``work/ppi``). Each path with
    the launch counts set to 0 just before it and read just after."""
    log("== phase 12: staged data, prepared data, optimizers, options")
    from euler_tpu_torch import datasets
    from euler_tpu_torch.datasets import build_synthetic
    from euler_tpu_torch.graph import Graph, MemoryGraph
    from euler_tpu_torch.models import base

    t_phase = time.perf_counter()
    ppi = ppi or datasets.PPI
    max_id = ppi["num_nodes"] - 1
    steps = (max_id + 1) // PPI_BATCH
    local_dir = os.path.join(work, "ppi")
    runs = {}

    def argv(data_dir, model_dir, *extra):
        return ["--data_dir", data_dir, "--model_dir",
                os.path.join(work, model_dir), "--max_id", str(max_id),
                "--seed", str(seed), *RUN_LOOP_ARGS, "--device_sampling",
                "1", *extra]

    # (a) staged and streamed
    try:
        import fsspec
    except ImportError as e:
        log(f"(a) fsspec is not importable ({e}): staged data cannot run")
        raise
    log(f"(a) fsspec {fsspec.__version__}")
    mem = fsspec.filesystem("memory")
    url = f"memory://{STAGED_ROOT}"
    t0 = time.perf_counter()
    uploaded = 0
    for name in sorted(os.listdir(local_dir)):
        if name.endswith(".dat") or name == "meta.json":
            with open(os.path.join(local_dir, name), "rb") as f:
                blob = f.read()
            mem.pipe_file(f"/{STAGED_ROOT}/{name}", blob)
            uploaded += len(blob)
    log(f"(a) {url}: {uploaded} B put in {time.perf_counter() - t0:.3f} s")
    cache = os.path.join(work, "staged_cache")
    graphs, digests = {}, {}
    try:
        for how, kw in (("streamed", dict(directory=url, stream=True)),
                        ("staged", dict(directory=url, cache_dir=cache)),
                        ("local", dict(directory=local_dir))):
            t0 = time.perf_counter()
            graphs[how] = Graph(**kw)
            load_ms = (time.perf_counter() - t0) * 1e3
            on_disk = sum(os.path.getsize(os.path.join(d, n))
                          for d, _, ns in os.walk(cache) for n in ns
                          ) if os.path.isdir(cache) else 0
            g = graphs[how]
            consts = mesh_sage(max_id).build_consts(g, device)
            digests[how] = (g.num_nodes, g.num_edges, tables_digest(consts))
            log(f"(a) {how}: Graph({', '.join(f'{k}=' for k in kw)}) "
                f"loaded {g.num_nodes} nodes, {g.num_edges} edges in "
                f"{load_ms:.1f} ms, {on_disk} B in the stage cache; device "
                f"tables ({table_bytes(consts)} B) sha256 "
                f"{digests[how][2][:16]}")
            del consts
        if len(set(digests.values())) != 1:
            raise AssertionError(f"staged loads differ: {digests}")
    finally:
        for g in graphs.values():
            g.close()
    runs["staged_ppi_stream"] = run_loop_epoch(
        "staged_ppi_stream", argv(url, "s1", "--stream", "1"), device, smi,
        steps)
    mem.rm(f"/{STAGED_ROOT}", recursive=True)

    # (b) the other optimizers
    small = MemoryGraph(**build_synthetic(2000, 15, 50, 121, seed=seed + 1))
    for opt in OTHER_OPTIMIZERS:
        agree_cpu_cuda(mesh_sage(small.max_node_id, dim=32), small, seed,
                       f"ppi_{opt}", optimizer=opt)
        runs[f"run_loop_{opt}"] = run_loop_epoch(
            f"run_loop_{opt}", argv(local_dir, f"o_{opt}", "--optimizer",
                                    opt), device, smi, steps)

    # (c) prepared: GraphSAGE-format files through the preparer's CLI
    src = os.path.join(work, "graphsage_ppi")
    os.makedirs(src)
    t0 = time.perf_counter()
    nbytes = write_graphsage_ppi(os.path.join(src, "ppi"), ppi["num_nodes"],
                                 ppi["feature_dim"], ppi["label_dim"],
                                 ppi["avg_degree"], seed)
    t1 = time.perf_counter()
    out = os.path.join(work, "prepared_ppi")
    r = subprocess.run(
        [sys.executable, "-m", "euler_tpu_torch.datasets", "prepare_ppi",
         "--prefix", os.path.join(src, "ppi"), "--out", out],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=PREP_TIMEOUT_S)
    prep_s = time.perf_counter() - t1
    if r.returncode != 0 or r.stdout.strip() != out:
        raise AssertionError(f"prepare_ppi exit {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    written = {n: os.path.getsize(os.path.join(out, n))
               for n in sorted(os.listdir(out))}
    log(f"(c) GraphSAGE-format ppi ({nbytes} B) written in {t1 - t0:.2f} s; "
        f"python -m euler_tpu_torch.datasets prepare_ppi in {prep_s:.2f} s "
        f"wrote {written}")
    runs["prepared_ppi"] = run_loop_epoch(
        "prepared_ppi", argv(out, "p1", "--train_node_type", "0"), device,
        smi, steps)

    # (d) the model options
    graph = Graph(directory=local_dir)
    f1, f2 = PPI_FANOUTS
    agree_cpu_cuda(mesh_unsup(small.max_node_id, 32, shared_negs=True),
                   small, seed, "graphsage_shared_negs")
    towers = PPI_BATCH * (2 + SAGE_NEGS)
    run = train_full(
        mesh_unsup(max_id, shared_negs=True), graph, seed, smi,
        "graphsage_shared_negs",
        PPI_BATCH + towers * (f1 + f1 * f2),
        f"{PPI_BATCH} + {towers} * {f1 + f1 * f2} sampled edges/step; each "
        f"root against all {PPI_BATCH * SAGE_NEGS} negatives")
    expect = {"sample_fanout2": 3 * run["steps"],
              "sample_neighbor": run["steps"]}
    if run["launches"] != expect:
        raise AssertionError(f"graphsage_shared_negs launches "
                             f"{run['launches']}, expected {expect}")
    runs["graphsage_shared_negs"] = run
    use_id = dict(use_id=True, embedding_dim=16)
    agree_cpu_cuda(mesh_sage(small.max_node_id, dim=32, **use_id), small,
                   seed, "ppi_use_id")
    run = train_full(mesh_sage(max_id, **use_id), graph, seed, smi,
                     "ppi_use_id", PPI_BATCH * (f1 + f1 * f2),
                     "512 * (10 + 10*10) sampled edges/step; an id "
                     "embedding of 16 beside the features")
    if run["launches"] != {"sample_fanout2": run["steps"],
                           "sample_neighbor": 0}:
        raise AssertionError(f"ppi_use_id launches {run['launches']}")
    runs["ppi_use_id"] = run
    model = mesh_sage(max_id)
    t0 = time.perf_counter()
    os.environ["EULER_TPU_FEATURE_DTYPE"] = "bfloat16"
    try:
        by_env = model.build_consts(graph, device)
    finally:
        del os.environ["EULER_TPU_FEATURE_DTYPE"]
    by_kwarg = mesh_sage(max_id, feature_dtype="bfloat16").build_consts(
        graph, device)
    ids = torch.as_tensor(np.random.default_rng(seed).integers(
        0, max_id + 2, 4096), dtype=torch.int32, device=device)
    rows = [base.gather_consts({"gids": ids}, c)["dense"]
            for c in (by_env, by_kwarg)]
    if not (by_env["features"].dtype == torch.bfloat16
            and torch.equal(by_env["features"], by_kwarg["features"])
            and torch.equal(rows[0], rows[1])):
        raise AssertionError("EULER_TPU_FEATURE_DTYPE's table differs from "
                             "feature_dtype's")
    log(f"(d) EULER_TPU_FEATURE_DTYPE=bfloat16: feature table "
        f"{by_env['features'].dtype} {tuple(by_env['features'].shape)}, "
        f"{table_bytes(by_env['features'])} B, equal to feature_dtype's; "
        f"4,096 gathered rows equal ({time.perf_counter() - t0:.2f} s)")
    graph.close()
    log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return runs


# phase 13: the operator's tools (euler_tpu_torch/scripts/) and
# --serve_after over a mesh. Each tool runs as a user runs it, in a
# process of its own, and must exit 0 within OPS_TIMEOUT_S
OPS_TIMEOUT_S = 600
OPS_WATCH = ["--watch", "1", "--iterations", "3"]
# mesh_serve_after: two ranks on the one card at model_parallel 2, then
# ZOO_SERVE_CLIENTS threads of ZOO_SERVE_REQUESTS requests each
MESH_SERVE_FLAGS = ["--device_sampling", "1", "--num_devices", "2",
                    "--model_parallel", "2"]


def run_cmd(argv, where: str, env=None, cwd=None,
            timeout: float = OPS_TIMEOUT_S) -> tuple:
    """``argv`` from the checkout (or ``cwd``) with the checkout on
    ``PYTHONPATH`` (or ``env``); ``(seconds, output)``, raising unless it
    exits 0."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run(argv, cwd=cwd or root,
                       env=env or dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=timeout)
    out = p.stdout + p.stderr
    if p.returncode != 0:
        raise AssertionError(f"{where}: {' '.join(argv)} exited "
                             f"{p.returncode}:\n{out[-4000:]}")
    return time.perf_counter() - t0, out


def json_line(out: str) -> dict:
    """The last line of a process's output that is a JSON object."""
    return json.loads(re.findall(r"^\{.*\}$", out, re.M)[-1])


def run_tool(tool: str, args, timeout: float = OPS_TIMEOUT_S) -> tuple:
    """``python -m euler_tpu_torch.scripts.<tool> args`` from the
    checkout; ``(seconds, output)``, raising unless it exits 0."""
    return run_cmd([sys.executable, "-m", f"euler_tpu_torch.scripts.{tool}",
                    *args], tool, timeout=timeout)


def tool_lines(out: str, *marks) -> str:
    """The output lines holding any of ``marks``, joined for the log."""
    return " | ".join(x.strip() for x in out.splitlines()
                      if any(m in x for m in marks))


def launch_line(out: str, where: str, n: int = 1) -> dict:
    """The ``n`` ``kernel launches {...}`` lines of a process's output
    (one a ``run_loop.main`` mode), summed by kernel."""
    found = [json.loads(x) for x in
             re.findall(r"kernel launches (\{.*\})", out)]
    if len(found) != n:
        raise AssertionError(f"{where}: {len(found)} launch lines, want {n}")
    return {k: sum(f.get(k, 0) for f in found) for k in found[0]}


def mesh_serve_after(work: str, seed: int, smi: str, device: str,
                     max_id: int) -> tuple:
    """mesh_serve_after: ``python -m euler_tpu_torch --num_devices 2
    --model_parallel 2 --device_sampling 1 --serve_after 1`` over phase
    5's ppi files, then clients, then the serve CLI on the same
    checkpoint; every row bit-equal to the CLI's, both drained to 0.
    Returns ``({path: {"launches"}}, seconds)``."""
    from euler_tpu_torch.serving import EmbedClient

    t0 = time.perf_counter()
    runs = {}
    model_dir = os.path.join(work, "m_serve_after")
    base = ["--data_dir", os.path.join(work, "ppi"), "--model_dir",
            model_dir, "--max_id", str(max_id), "--seed", str(seed),
            *RUN_LOOP_ARGS]
    proc, lines, addr, reader = serve_cli(
        [*base, *MESH_SERVE_FLAGS, "--serve_after", "1", "--serve_port",
         "0", "--serve_max_batch", str(SERVE_MAX_BATCH)], device,
        module="euler_tpu_torch")
    ref = None
    try:
        up = time.perf_counter() - t0
        reqs = serve_traffic(max_id, seed + 13,
                             ZOO_SERVE_CLIENTS * ZOO_SERVE_REQUESTS)
        rows, lat, wall = drive_clients(addr, reqs, ZOO_SERVE_CLIENTS,
                                        "mesh_serve_after")
        served = {}
        for req, got in zip(reqs, rows):
            for nid, row in zip(req, got):
                if nid in served and not np.array_equal(served[nid], row):
                    raise AssertionError(f"mesh_serve_after: id {nid} "
                                         "served two different rows")
                served[nid] = row
        # the serve CLI on the same checkpoint, as a device-sampled mesh
        # run's checkpoint is served: host-sampled over device tables
        ref, _, ref_addr, ref_reader = serve_cli(
            [*base, "--device_sampling", "0", "--device_features", "1",
             "--num_devices", "2", "--model_parallel", "2",
             "--serve_port", "0", "--serve_max_batch",
             str(SERVE_MAX_BATCH)], device)
        ids = sorted(served)
        c = EmbedClient(ref_addr, timeout_s=60.0)
        try:
            want_rows = np.concatenate(
                [c.embed(ids[i:i + SERVE_MAX_IDS])
                 for i in range(0, len(ids), SERVE_MAX_IDS)])
        finally:
            c.close()
        got_rows = np.stack([served[i] for i in ids])
        if not np.array_equal(got_rows, want_rows):
            raise AssertionError(
                "mesh_serve_after: rows differ from the serve CLI's (max "
                f"abs {np.abs(got_rows - want_rows).max()})")
        for p, r in ((ref, ref_reader), (proc, reader)):
            p.send_signal(signal.SIGTERM)
            if p.wait(120) != 0:
                raise AssertionError(f"mesh_serve_after: a server exited "
                                     f"{p.returncode}")
            r.join(10)
    finally:
        for p in (proc, ref):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(10)
    text = "\n".join(lines)
    if "serve SLO at exit" not in text:
        raise AssertionError("mesh_serve_after did not drain:\n"
                             + "\n".join(lines[-40:]))
    steps = (max_id + 1) // PPI_BATCH
    for rank in range(2):
        found = re.findall(rf"rank{rank} kernel launches (\{{.*\}})", text)
        if len(found) != 1:
            raise AssertionError(f"mesh_serve_after: rank {rank} logged "
                                 f"{len(found)} launch lines")
        got = json.loads(found[0])
        want = {"sample_fanout2": steps, "sample_neighbor": 0,
                "sample_fanout2_sharded": steps,
                "sample_neighbor_sharded": 0}
        if device == "cuda" and got != want:
            raise AssertionError(f"mesh_serve_after rank {rank}: launches "
                                 f"{got} != {want}")
        runs[f"mesh_serve_after/rank{rank}"] = {"launches": got}
    step_line = re.compile(r"rank0 step=(\d+) loss=(\S+)")
    losses = [float(m.group(2)) for m in step_line.finditer(text)]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"mesh_serve_after: {len(losses)} logged "
                             f"steps of {steps}")
    secs = time.perf_counter() - t0
    flags = " ".join(MESH_SERVE_FLAGS)
    by_rank = [runs[f"mesh_serve_after/rank{r}"]["launches"] for r in (0, 1)]
    log(f"mesh_serve_after: python -m euler_tpu_torch {flags} "
        f"--serve_after 1: {steps} steps, loss "
        f"{np.mean(losses[:5]):.4f} (first 5) -> {np.mean(losses[-5:]):.4f}"
        f" (last 5), serving after {up:.2f} s; {len(reqs)} requests from "
        f"{ZOO_SERVE_CLIENTS} clients in {wall:.2f} s, client p50 "
        f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f}"
        f" ms; {len(ids)} ids' rows bit-equal to python -m "
        f"euler_tpu_torch.serve --model_parallel 2's on the same "
        f"checkpoint; launches by rank {by_rank}; SIGTERM drained both to "
        f"exit 0 ({secs:.2f} s, beside the tools; card: {smi})")
    return runs, secs


def phase_ops(work: str, seed: int, smi: str, device: str = "cuda",
              max_id: int = 56943) -> dict:
    """Phase 13: the operator's tools and ``--serve_after`` over a mesh,
    each path a subprocess that must exit 0 (its count of launches is its
    own process's, from 0). Three lanes at once: mesh_serve_after; the
    six self-checks while the phase's two shards load; then the tools
    over those shards and phase 9's artifacts beside both drills.
    Returns the paths that launch a kernel."""
    log("== phase 13: operations")
    from euler_tpu_torch.scripts import devprof_dump

    t_phase = time.perf_counter()
    data_dir = os.path.join(work, "ppi")
    obs = os.path.join(work, "obs")
    dev = ["--device", device]
    runs = {}
    secs = {}

    def together(jobs) -> dict:
        """``[(path, tool, args, marks)]`` at once, each logged; returns
        each output by ``(tool, first argument)``."""
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
            done = list(ex.map(lambda j: run_tool(j[1], j[2]), jobs))
        outs = {}
        for (path, tool, args, marks), (dt, out) in zip(jobs, done):
            secs[path] = secs.get(path, 0.0) + dt
            log(f"{path}: {tool} {' '.join(args)}: exit 0 in {dt:.2f} s "
                f"({len(jobs)} tools at once)"
                + (f"; {tool_lines(out, *marks)}" if marks else "")
                + f" (card: {smi})")
            outs[tool, args[0]] = out
        return outs

    reg = os.path.join(work, "ops_reg")
    os.makedirs(reg)
    with concurrent.futures.ThreadPoolExecutor(1) as lane:
        mesh = lane.submit(mesh_serve_after, work, seed, smi, device,
                           max_id)
        shards = [Shard(i, data_dir, reg) for i in range(REMOTE_SHARDS)]
        try:
            outs = together([
                ("ops_metrics_dump", "metrics_dump", ["--smoke"],
                 ("smoke: OK",)),
                ("ops_trace_dump", "trace_dump", ["--smoke", *dev],
                 ("smoke: OK",)),
                ("ops_postmortem", "postmortem", ["--smoke"],
                 ("smoke: OK",)),
                ("ops_heat_dump", "heat_dump", ["--smoke"],
                 ("edge-cut", "smoke: OK")),
                ("ops_heat_dump", "heat_dump", ["--ab-smoke"],
                 ("edge-cut", "smoke: OK")),
                ("ops_devprof_dump", "devprof_dump", ["--smoke", *dev],
                 ("recompile", "B1 (", "kernel launches", "smoke: OK"))])
            # the device plane: B1 in the kernel table as often as it
            # launched
            launches = launch_line(outs["devprof_dump", "--smoke"],
                                   "devprof_dump --smoke")
            want = devprof_dump.SMOKE_STEPS + 2  # warm-up, window, drift
            if device == "cuda" and launches["sample_fanout2"] != want:
                raise AssertionError(f"devprof_dump --smoke: launches "
                                     f"{launches}, want sample_fanout2 "
                                     f"{want}")
            runs["ops_devprof_dump"] = {"launches": launches}

            for sh in shards:
                sh.wait_up()
            merged = os.path.join(work, "ops_merged.json")
            prof = os.path.join(obs, "profile")
            outs = together([
                ("ops_metrics_dump", "metrics_dump",
                 ["--registry", reg, *OPS_WATCH], ("served +",)),
                ("ops_trace_dump", "trace_dump",
                 ["--input", os.path.join(obs, "trace.json"), "--registry",
                  reg, "--out", merged], ("events ->",)),
                ("ops_postmortem", "postmortem",
                 ["--dir", os.path.join(obs, "segv"), "--trace",
                  os.path.join(obs, "trace.json"), "--out",
                  os.path.join(work, "ops_incident.json")],
                 ("SIGSEGV", "incident trace")),
                ("ops_devprof_dump", "devprof_dump",
                 ["--profile_dir", prof, "--topk",
                  str(devprof_dump.SMOKE_TOPK)], ("device kernels",)),
                # the drills at the JAX scripts' defaults
                ("ops_epoch_drill", "epoch_drill", dev,
                 ("epoch drill:", "flipped", "zero failed", "loss parity",
                  "bit-identical to fresh", "drill OK")),
                ("ops_serve_drill", "serve_drill", dev,
                 ("served ", "p99 ", "shedding", "bit-identical",
                  "drill OK"))])
            out = outs["metrics_dump", "--registry"]
            for i in range(REMOTE_SHARDS):
                n = out.count(f"] shard {i}: served +")
                if n != 3:
                    raise AssertionError(
                        f"metrics_dump --watch: shard {i} in {n} of 3 "
                        f"scrapes:\n{out[-2000:]}")
            with open(merged) as f:
                pids = {e["pid"] for e in json.load(f)["traceEvents"]}
            if not {100, 101} <= pids:
                raise AssertionError(f"trace_dump --input: lanes "
                                     f"{sorted(pids)}")
            if "SIGSEGV (signal 11)" not in outs["postmortem", "--dir"]:
                raise AssertionError(
                    f"postmortem --dir: {outs['postmortem', '--dir']}")
            for sh in shards:
                if sh.drain() != 0:
                    raise AssertionError(f"shard {sh.idx} did not drain "
                                         "to 0")
        finally:
            for sh in shards:
                sh.kill()
        # phase 9's capture: B1 once in each of its profiled steps
        with contextlib.redirect_stdout(io.StringIO()):  # rows unclipped
            rows = devprof_dump.kernel_table(prof,
                                             topk=devprof_dump.SMOKE_TOPK)
        b1 = [r for r in rows if devprof_dump.B1_SYMBOL in r[0]]
        steps_profiled = OBS_PROFILE_STEPS[1] - OBS_PROFILE_STEPS[0]
        if device == "cuda" and [r[2] for r in b1] != [steps_profiled]:
            raise AssertionError(f"devprof_dump --profile_dir: B1 rows "
                                 f"{b1}, want one of {steps_profiled}")
        log(f"ops_devprof_dump: phase 9's capture: B1 row {b1}")
        mesh_runs, secs["mesh_serve_after"] = mesh.result()
    runs.update(mesh_runs)
    log("phase 13 seconds by path (lanes at once): "
        + json.dumps({k: round(v, 2) for k, v in secs.items()}))
    log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return runs


# phase 14 (from install to a model that learns): the convergence gate's
# cases that draw through B1 once a step, the examples' steps and log
# window and dist_train.sh's shards. A window logs its last step's loss,
# and the custom example's loss settles within its first 100 steps, so
# the examples' own windows of 100 cannot show it fall (0.361, 0.356,
# 0.411 on the card); windows of 10 catch the first steps
GATE_DEVICE_SAMPLING = ("graphsage_device_sampling", "scan_train")
EXAMPLE_STEPS = 300
EXAMPLE_LOG_EVERY = 10
DIST_SHARDS = 2
# the custom example's graph (the replica's labels come from each node's
# own features, which the example's neighbours-only aggregation never
# reads): Reddit's node count, features and classes over planted
# communities at noise 0.5, where nearest-centroid accuracy is 0.44 on a
# node's features and 0.99 after one hop of averaging (at 20,000 nodes),
# the regime of the convergence gate's graph (0.56 and 0.94)
PLANTED_REDDIT = dict(num_nodes=232965, num_communities=41, feature_dim=602,
                      noise=0.5, num_partitions=2)
# pip offline: the checkout's own files, no index, no version check
PIP_OFFLINE = ["--no-deps", "--no-index", "--disable-pip-version-check"]


def reddit_replica(num_nodes: int | None = None) -> ChildData:
    """The Reddit rehearsal's replica files and their preparation
    (``reddit_dress_rehearsal.prepare`` at the script's defaults: 232,965
    nodes x 602 features, 41 classes, average degree 25) into
    ``workdir/dat``; its result is the prepare half of the summary."""
    from euler_tpu_torch.scripts import reddit_dress_rehearsal as r

    code = ("import json, sys\n"
            "from euler_tpu_torch.scripts import reddit_dress_rehearsal as r\n"
            "print(json.dumps(r.prepare(sys.argv[1], int(sys.argv[2]), "
            "r.AVG_DEGREE)))\n")
    child = ChildData("the Reddit replica's preparation", code,
                      num_nodes or r.NUM_NODES)
    child.num_nodes = num_nodes or r.NUM_NODES
    return child


def planted_reddit(num_nodes: int = PLANTED_REDDIT["num_nodes"]) -> ChildData:
    """A planted-community graph of Reddit's shape (``build_planted``:
    PLANTED_REDDIT's nodes, 602 features, 41 communities as one-hot
    labels, 90% of edges inside a community) in ``workdir/dat``: the
    graph on which a model that aggregates neighbours alone can learn."""
    # without build_planted's done marker the files read as prepared
    # data, which the example's build_reddit keeps
    code = ("import json, os, sys, time\n"
            "from euler_tpu_torch.datasets import build_planted\n"
            "t0 = time.perf_counter()\n"
            "out, _ = build_planted(sys.argv[1] + '/dat', "
            "**json.loads(sys.argv[2]))\n"
            "os.remove(os.path.join(out, 'done'))\n"
            "print(json.dumps({'build_s': time.perf_counter() - t0}))\n")
    return ChildData("the planted Reddit-shaped graph's build", code,
                     json.dumps(dict(PLANTED_REDDIT, num_nodes=num_nodes)))


def learn_gate(work: str, smi: str, device: str) -> dict:
    """Phase 14 (a): the ten cases of the convergence gate
    (``euler_tpu_torch.convergence``, the JAX ``tests/
    test_convergence.py``'s) on ``device``, each with the launch counts
    set to 0 just before it and read just after: B1 once a training step
    on the two device-sampling cases, no other draw kernel. Prints each
    figure beside its floor; raises after the last case if any missed."""
    from euler_tpu_torch import convergence
    from euler_tpu_torch.graph import sampling_kernels

    p = convergence.planted(os.path.join(work, "planted"))
    log(f"gate: planted graph {convergence.NUM_NODES} nodes, feat_acc "
        f"{p.feat_acc:.4f}, hop1_acc {p.hop1_acc:.4f}")
    runs, missed = {}, []
    try:
        for name in convergence.CASES:
            for k in sampling_kernels.launches:
                sampling_kernels.launches[k] = 0
            t0 = time.perf_counter()
            r = convergence.run_case(name, p, device)
            dt = time.perf_counter() - t0
            launches = dict(sampling_kernels.launches)
            want = {"sample_fanout2": r["steps"] if device == "cuda"
                    and name in GATE_DEVICE_SAMPLING else 0,
                    "sample_neighbor": 0}
            if r["launches"] != want:
                raise AssertionError(f"gate {name}: launches while "
                                     f"training {r['launches']}, want "
                                     f"{want}")
            missed += [name] if convergence.misses(r) else []
            log(f"gate_{name}: {convergence.describe(name, r)}"
                f"{' MISSED' if convergence.misses(r) else ''}; "
                f"{r['steps']} steps, launches {launches} (training "
                f"{r['launches']}), {dt:.2f} s (card: {smi})")
            runs[f"gate_{name}"] = {"launches": launches,
                                    "seconds": dt, **r["figures"]}
    finally:
        p.graph.close()
    if missed:
        raise AssertionError(f"convergence gate missed: {missed}")
    return runs


def ppi_rehearsal(work: str, smi: str, device: str = "cuda") -> tuple:
    """Phase 14 (b): ``python -m euler_tpu_torch.scripts.
    ppi_dress_rehearsal`` at its defaults (56,944 nodes, dim 256, batch
    512, one epoch) in ``work/ppi_rehearsal``: exit 0 and val micro-F1
    above the all-positive predictor's plus 0.1. Returns the run and the
    prepared directory."""
    workdir = os.path.join(work, "ppi_rehearsal")
    os.makedirs(workdir)
    dt, out = run_cmd([sys.executable, "-m",
                       "euler_tpu_torch.scripts.ppi_dress_rehearsal",
                       "--workdir", workdir, "--device", device],
                      "ppi_rehearsal")
    summary = json_line(out)
    f1, base = summary["val_metrics"]["f1"], summary["splits"]["allpos_f1"]
    if not f1 > base + 0.1:
        raise AssertionError(f"ppi_rehearsal: val f1 {f1} vs all-positive "
                             f"{base} + 0.1: {summary}")
    launches = launch_line(out, "ppi_rehearsal", 2)
    log(f"ppi_rehearsal: {json.dumps(summary)}; val f1 {f1:.4f} (floor "
        f"{base + 0.1:.4f}), launches {launches}, {dt:.2f} s (card: {smi})")
    return {"launches": launches, "seconds": dt,
            "summary": summary}, os.path.join(workdir, "dat")


def reddit_rehearsal(replica: ChildData, smi: str,
                     device: str = "cuda") -> dict:
    """Phase 14 (c): the Reddit rehearsal at its defaults (232,965 nodes x
    602, average degree 25, one epoch at batch 1,000): its replica
    prepared by the child from phase 3 on, then ``train_and_evaluate`` in
    a process of its own: both modes exit 0 and the val accuracy clears
    the majority class's plus 0.1."""
    prep = replica.result()
    code = ("import json, sys\n"
            "from euler_tpu_torch.scripts import reddit_dress_rehearsal"
            " as r\n"
            "print(json.dumps(r.train_and_evaluate(sys.argv[1], "
            "int(sys.argv[2]), r.EPOCHS, r.BATCH_SIZE, sys.argv[3])))\n")
    dt, out = run_cmd([sys.executable, "-c", code, replica.workdir,
                       str(replica.num_nodes), device], "reddit_rehearsal")
    summary = {"num_nodes": replica.num_nodes, "card": smi, **prep,
               **json_line(out)}
    if not (summary["train_rc"] == 0 and summary.get("evaluate_rc") == 0):
        raise AssertionError(f"reddit_rehearsal: {summary}")
    acc, base = summary["val_metrics"]["f1"], summary["splits"][
        "majority_acc"]
    if not acc > base + 0.1:
        raise AssertionError(f"reddit_rehearsal: val {acc} vs majority "
                             f"{base} + 0.1: {summary}")
    launches = launch_line(out, "reddit_rehearsal", 2)
    log(f"reddit_rehearsal: {json.dumps(summary)}; val {acc:.4f} (floor "
        f"{base + 0.1:.4f}), launches {launches}, train and evaluate "
        f"{dt:.2f} s (card: {smi})")
    return {"launches": launches, "seconds": dt, "summary": summary}


def example_run(name: str, data_dir: str, smi: str,
                device: str = "cuda") -> dict:
    """Phase 14 (d): ``euler_tpu_torch.examples.<name>.main`` at its
    widths in a process of its own for EXAMPLE_STEPS steps over
    ``data_dir`` (prepared files, which the example's ``build_ppi`` or
    ``build_reddit`` keeps as a real dataset), logging a window every
    EXAMPLE_LOG_EVERY steps (the child sets ``train.train``'s
    ``log_every``; the example's own is 100): every window's loss
    finite, the mean of the last three below that of the first three,
    and the draw kernels' launches."""
    code = ("import importlib, json, sys\n"
            "from euler_tpu_torch import train\n"
            "from euler_tpu_torch.graph import sampling_kernels\n"
            "fit = train.train\n"
            "train.train = lambda *a, **k: fit(*a, **dict(k, log_every=int("
            "sys.argv[2])))\n"
            "mod = importlib.import_module('euler_tpu_torch.examples.' + "
            "sys.argv[1])\n"
            "history = mod.main(sys.argv[3:])\n"
            "print('kernel launches', json.dumps(sampling_kernels.launches))\n"
            "print('history', json.dumps(history))\n")
    dt, out = run_cmd([sys.executable, "-c", code, name,
                       str(EXAMPLE_LOG_EVERY), "--data_dir", data_dir,
                       "--steps", str(EXAMPLE_STEPS), "--device", device],
                      f"example_{name}")
    history = json.loads(re.findall(r"^history (.*)$", out, re.M)[-1])
    losses = np.array([h["loss"] for h in history])
    head, tail = float(losses[:3].mean()), float(losses[-3:].mean())
    if not (len(losses) == EXAMPLE_STEPS // EXAMPLE_LOG_EVERY
            and np.isfinite(losses).all() and tail < head):
        raise AssertionError(f"example {name}: window losses {losses}")
    launches = launch_line(out, f"example_{name}", 1)
    log(f"example_{name}: {EXAMPLE_STEPS} steps, loss {head:.5f} (first "
        f"three windows of {EXAMPLE_LOG_EVERY}) -> {tail:.5f} (last three), "
        f"f1 {history[-1]['f1']:.4f} (last window), steps/s "
        f"{np.mean([h['steps_per_sec'] for h in history[1:]]):.2f}, "
        f"launches {launches}, {dt:.2f} s (card: {smi})")
    return {"launches": launches, "seconds": dt, "loss_head": head,
            "loss_tail": tail}


def dist_train(work: str, smi: str, max_id: int) -> dict:
    """Phase 14 (d): ``euler_tpu_torch/examples/dist_train.sh`` over
    DIST_SHARDS shards of phase 5's ppi files (one shard process, the
    training process serving shard 0, ``--graph_mode shared``) for an
    epoch at ppi's widths: every step's loss finite, no draw kernel (the
    fanouts come over the wire)."""
    root = os.path.dirname(os.path.abspath(__file__))
    steps = (max_id + 1) // PPI_BATCH
    dt, out = run_cmd(
        ["bash", os.path.join(root, "euler_tpu_torch", "examples",
                              "dist_train.sh"),
         os.path.join(work, "ppi"), str(DIST_SHARDS), "--max_id",
         str(max_id), "--model_dir", os.path.join(work, "dist_ck"),
         *RUN_LOOP_ARGS],
        "dist_train", env=dict(os.environ, PYTHONPATH=root,
                               PYTHON=sys.executable))
    losses = [float(m.group(2)) for m in _STEP_LINE.finditer(out)]
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"dist_train: {len(losses)} steps of {steps}"
                             f":\n{out[-3000:]}")
    launches = launch_line(out, "dist_train", 1)
    if any(launches.values()):
        raise AssertionError(f"dist_train: launches {launches}")
    log(f"dist_train: {DIST_SHARDS} shards, {steps} steps, loss "
        f"{np.mean(losses[:10]):.5f} (first 10) -> "
        f"{np.mean(losses[-10:]):.5f} (last 10), launches {launches}, "
        f"{dt:.2f} s (card: {smi})")
    return {"launches": launches, "seconds": dt}


def installed_run(work: str, smi: str, max_id: int) -> dict:
    """Phase 14 (e): the package as a user installs it. ``pip wheel
    --no-deps --no-build-isolation`` of the checkout, ``pip install
    --no-deps --target``, then the installed ``euler-tpu-torch`` command
    from a directory outside the checkout, with only the install on
    ``PYTHONPATH``, trains an epoch of phase 12's prepared ppi files
    drawn on the card: the engine and the kernels built under the
    install from its own sources, B1 once a step."""
    root = os.path.dirname(os.path.abspath(__file__))
    inst = os.path.join(work, "install")
    wheels, target, outside = (os.path.join(inst, d)
                               for d in ("wheel", "site", "cwd"))
    os.makedirs(outside)
    pip = [sys.executable, "-m", "pip"]
    t_wheel, _ = run_cmd([*pip, "wheel", *PIP_OFFLINE,
                          "--no-build-isolation", "-w", wheels, root],
                         "pip wheel")
    (wheel,) = [os.path.join(wheels, w) for w in os.listdir(wheels)]
    import zipfile

    with zipfile.ZipFile(wheel) as z:
        shipped = [n for n in z.namelist()
                   if "euler_tpu_torch/graph/_native/" in n
                   or "euler_tpu_torch/csrc/" in n]
    t_install, _ = run_cmd([*pip, "install", *PIP_OFFLINE, "--target",
                            target, wheel], "pip install")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = target
    _, where = run_cmd([sys.executable, "-c",
                        "import euler_tpu_torch; "
                        "print(euler_tpu_torch.__file__)"],
                       "installed import", env=env, cwd=outside)
    if not where.strip().startswith(target + os.sep):
        raise AssertionError(f"installed import: {where.strip()}")
    steps = (max_id + 1) // PPI_BATCH
    t_run, out = run_cmd(
        [os.path.join(target, "bin", "euler-tpu-torch"), "--data_dir",
         os.path.join(work, "prepared_ppi"), "--model_dir",
         os.path.join(inst, "ck"), "--max_id", str(max_id),
         "--train_node_type", "0", "--device_sampling", "1",
         *RUN_LOOP_ARGS], "euler-tpu-torch", env=env, cwd=outside)
    losses = [float(m.group(2)) for m in _STEP_LINE.finditer(out)]
    launches = launch_line(out, "euler-tpu-torch", 1)
    if (len(losses) != steps or not np.isfinite(losses).all()
            or launches.get("sample_fanout2") != steps):
        raise AssertionError(f"euler-tpu-torch: {len(losses)} steps of "
                             f"{steps}, launches {launches}:\n"
                             f"{out[-3000:]}")
    build = os.path.join(target, "build", "euler_tpu_torch")
    built = sorted(os.path.relpath(os.path.join(d, n), target)
                   for d, _, names in os.walk(build) for n in names
                   if n.endswith(".so"))
    if (len([b for b in built if "libeuler_graph_torch_" in b]) != 1
            or len([b for b in built if "libeuler_tpu_torch_" in b]) != 1):
        raise AssertionError(f"installed builds under {build}: {built}")
    log(f"installed_run: pip wheel {t_wheel:.2f} s ({os.path.basename(wheel)}"
        f", {len(shipped)} engine and kernel sources), pip install "
        f"{t_install:.2f} s, euler-tpu-torch from {outside} {t_run:.2f} s: "
        f"{steps} steps, loss {np.mean(losses[:10]):.5f} (first 10) -> "
        f"{np.mean(losses[-10:]):.5f} (last 10), launches {launches}, "
        f"built from the install's sources: {built} (card: {smi})")
    return {"launches": launches, "seconds": t_wheel + t_install + t_run}


def phase_learn(work: str, smi: str, replica: ChildData,
                planted: ChildData, device: str = "cuda",
                max_id: int = 56943) -> dict:
    """Phase 14: from install to a model that learns. Four lanes of
    processes run beside the gate, which trains in this process: the ppi
    rehearsal then the ppi example on its prepared files; the Reddit
    rehearsal on the child's replica, then ``sage_reddit`` on its
    prepared files beside ``custom_sage_reddit`` on the other child's
    planted Reddit-shaped graph; dist_train.sh; the wheel, its install
    and the installed command. On the CPU (a rehearsal of the phase) the last two
    lanes, whose commands run on the card only, are left out."""
    log("== phase 14: from install to a model that learns")
    t_phase = time.perf_counter()
    runs = {}

    def ppi_lane():
        out, dat = ppi_rehearsal(work, smi, device)
        return {"ppi_rehearsal": out,
                "example_sage": example_run("sage", dat, smi, device)}

    def reddit_lane():
        out = {"reddit_rehearsal": reddit_rehearsal(replica, smi, device)}
        log(f"planted Reddit-shaped graph: {planted.result()}")
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            done = {name: ex.submit(example_run, name,
                                    os.path.join(d.workdir, "dat"), smi,
                                    device)
                    for name, d in (("sage_reddit", replica),
                                    ("custom_sage_reddit", planted))}
            out.update({f"example_{n}": f.result() for n, f in done.items()})
        return out

    jobs = [ppi_lane, reddit_lane]
    if device == "cuda":
        jobs += [lambda: {"dist_train": dist_train(work, smi, max_id)},
                 lambda: {"installed_run": installed_run(work, smi, max_id)}]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as lanes:
        futures = [lanes.submit(job) for job in jobs]
        add_runs(runs, learn_gate(work, smi, device))
        for fut in futures:
            add_runs(runs, fut.result())
    log("phase 14 seconds by path (lanes at once): " + json.dumps(
        {k: round(v["seconds"], 2) for k, v in runs.items()}))
    log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return runs


def add_runs(runs: dict, new: dict) -> None:
    """``runs.update(new)``, raising where a path's name is taken: the
    kernels line counts launches by path name."""
    taken = sorted(set(runs) & set(new))
    if taken:
        raise AssertionError(f"paths named twice: {taken}")
    runs.update(new)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    t1 = time.perf_counter()
    log(f"phases 1-2: {t1 - t0:.1f} s")
    replica, planted = reddit_replica(), planted_reddit()
    try:
        return run_phases(args.seed, smi, replica, planted, t1)
    finally:
        replica.close()
        planted.close()


def run_phases(seed: int, smi: str, replica: ChildData, planted: ChildData,
               t1: float) -> int:
    """Phases 3 to 15, phase 14's Reddit data made from the start."""
    heavy = HeavyTailBuild()
    try:
        graph, hetero, reddit, k = phase_kernel(seed, smi)
        t2 = time.perf_counter()
        log(f"phase 3: {t2 - t1:.1f} s")
        runs = phase_train(graph, hetero, reddit, seed, smi, heavy)
    finally:
        heavy.close()
    t3 = time.perf_counter()
    log(f"phase 4: {t3 - t2:.1f} s")
    del graph, hetero, reddit
    with scratch_dir() as work:
        add_runs(runs, phase_engine(seed, smi, workdir=work))
        add_runs(runs, cli_wide(work, seed, smi))
        t4 = time.perf_counter()
        log(f"phase 5: {t4 - t3:.1f} s")
        add_runs(runs, phase_serve(os.path.join(work, "ppi"),
                                   os.path.join(work, "m2"), seed, smi))
        t5 = time.perf_counter()
        log(f"phase 6: {t5 - t4:.1f} s")
        add_runs(runs, phase_zoo(work, seed, smi))
        t6 = time.perf_counter()
        log(f"phase 7: {t6 - t5:.1f} s")
        add_runs(runs, phase_remote(work, seed, smi))
        t7 = time.perf_counter()
        log(f"phase 8: {t7 - t6:.1f} s")
        add_runs(runs, phase_observe(work, seed, smi))
        t8 = time.perf_counter()
        log(f"phase 9: {t8 - t7:.1f} s")
        add_runs(runs, phase_serve_zoo(work, seed, smi))
        t9 = time.perf_counter()
        log(f"phase 10: {t9 - t8:.1f} s")
        mesh_runs, routes = phase_mesh(work, seed, smi)
        add_runs(runs, mesh_runs)
        t10 = time.perf_counter()
        log(f"phase 11: {t10 - t9:.1f} s")
        add_runs(runs, phase_staged(work, seed, smi))
        t11 = time.perf_counter()
        log(f"phase 12: {t11 - t10:.1f} s")
        add_runs(runs, phase_ops(work, seed, smi))
        t12 = time.perf_counter()
        log(f"phase 13: {t12 - t11:.1f} s")
        add_runs(runs, phase_learn(work, smi, replica, planted))
    log(f"phase 14: {time.perf_counter() - t12:.1f} s")
    log("== phase 15: kernels")
    meta = {
        "sample_fanout2": dict(
            source="euler_tpu_torch/csrc/sample_fanout2.cu",
            replaces="euler_tpu/graph/pallas_sampling.py:481",
            tpu_kernel="_fanout2_kernel"),
        "sample_neighbor": dict(
            source="euler_tpu_torch/csrc/sample_neighbor.cu",
            replaces="euler_tpu/graph/pallas_sampling.py:302",
            tpu_kernel="_kernel"),
        # the per-rank routes of a data-sharded batch: the same kernels on
        # each rank's rows with its folded seed words
        "sample_fanout2_sharded": dict(
            source="euler_tpu_torch/graph/sampling_kernels.py",
            replaces="euler_tpu/graph/pallas_sampling.py:715",
            tpu_kernel="sample_fanout2_sharded (via draw_fn: "
                       "_fanout2_kernel)"),
        "sample_neighbor_sharded": dict(
            source="euler_tpu_torch/graph/sampling_kernels.py",
            replaces="euler_tpu/graph/pallas_sampling.py:757",
            tpu_kernel="sample_neighbor_sharded (via draw_fn: _kernel)"),
    }
    wide_routes = k.pop("wide_routes")
    k = {**k, **routes}
    for name, r in wide_routes.items():  # phase 3 (q): W = 2,048
        k[name]["wide"] = r
    kernels = []
    for name, m in meta.items():
        # the sharded routes' counts are read on phase 11's paths only
        by_path = {p: r["launches"][name] for p, r in runs.items()
                   if name in r["launches"]}
        kernels.append(dict(
            name=name, route="cuda", **m,
            launches=sum(by_path.values()), launches_by_path=by_path,
            **k[name]))
        if not kernels[-1]["launches"]:
            raise AssertionError(f"{name}: no launch on any path")
    log(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
