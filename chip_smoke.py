#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, on a machine with a card
    python3 chip_smoke.py --parallel-only   # the build, then phase 20 alone

Phases, one JSON line each:

1. build: the card's name and power limit (``nvidia-smi``), then ``nvcc``
   builds every kernel from ``deepaco_tpu_torch/csrc/``;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B=100 instances, N=500, K=50, A=20): K1 ``allclose`` at
   rtol 1e-4 / atol 1e-5 (the kernel sums in another order) and ``log(heu)``
   on each row's K nearest columns within 1e-4, K2 greedy paths
   exactly equal and stochastic tours that are permutations with a mean cost
   within 2% of the plain sweep's, K3 (the update with the next bf16 score
   on an iteration of the main path) tau' and costs at rtol 1e-6, its best
   state and score bit-equal to what ``track_best`` and ``next_score`` make
   of its own costs and tau';
3. K1 on the NLS configuration, then K4 (2-opt) and K5 (NLS) against their
   plain versions, tours exactly equal and permutations: on the NLS path's
   own inputs (its B=16 instances, N=500, tours that K2 samples from city 0
   on the ``tsp_nls500_selftrained`` heuristic, A=20, budget 10000, t_nls
   10, t_p 20), and at N=1100 on random permutations (A=2, budget 50,
   t_nls 1, t_p 5); K5 with the real asymmetric metric ``heuristic_dist``,
   and timed once more with t_nls 0 (its Euclidean descents alone);
4. the main path: ``evaluate_tsp`` on the neural arm with the
   ``tsp500_selftrained`` weights (T=1 and 10), its phase times and each
   kernel's launches in that run; the classic arm on the same batch; and the
   plain path on the card, whose cost@T10 the kernel path must match to 1%;
5. the NLS path: ``evaluate_tsp(ls="nls")`` with ``tsp_nls500_selftrained``
   on the first B=16 instances (N=500, K=50, A=20, T=1 and 10) through the
   kernels and through the plain versions, whose cost@T10 it must match to
   1%, and the classic arm with ``ls="2opt"``; NLS cost@T1 must lie below
   the main path's cost@T10;
6. the training kernels against their plain versions at the TSP-NLS
   training shapes (B=20, N=500, K=50, U=32, real k-NN neighbours): K6's
   forward (``agg``, ``pre``) and backward (all six input gradients under a
   mixed loss, and the backward entry on the same cotangents), K6's forward
   without ``pre`` (TPU kernel row 8, ``gated_mean_aggregate``), and K7 on
   [600, 500] rows mid-rollout with the same noise (actions exactly equal);
7. one training step in each configuration, kernel arm against plain arm
   from the same weights and instances: the kernel arm samples with
   ``rollout(require_prob=True)`` through K6, K7r (and K5 for NLS), the
   plain arm replays its paths through ``path_log_probs`` with the plain
   layer; loss, every gradient, the running statistics and the updated
   weights must agree; K7r (``fused_rollout``, the whole rollout in one
   launch forward and one backward) on each step's own score, starts and
   noise (TSP500: B=1, 50 ants, uniform starts; TSP500-NLS: B=20, 30 ants
   from city 0) against ``fused_rollout_plain`` and ``rollout_backward_plain``
   (``check_rollout``: paths exact, log-probabilities rtol 1e-5, d_score
   within 1e-4 of its largest entry, a repeat bit-equal), each direction's
   time by CUDA events and by the profiler, and its peak memory;
8. ``train_tsp`` in both configurations at full width, nothing cut: TSP500
   (dual-head Net, 50 ants, batch 1, lr 3e-4, 4 steps) and TSP500-NLS (the
   one-hot start Net, 30 ants, batch 20, lr 6e-4 cosine over 20x20 steps,
   NLS advantage, 2 steps), per step its loss, mean cost, gradient norm,
   wall, phase times and peak memory; the kernels' counts are set to 0 just
   before each run and read just after: one K7r launch each way a step and
   no K7; one more step under the profiler (the device's busy time, idle
   share and launches a step). The NLS state is saved with
   ``save_checkpoint``, read back with ``load_checkpoint`` and
   ``Net.from_jax_variables`` and evaluated with ``evaluate_tsp`` (4
   instances, T=1);
9. K8 (``tour_deposit``) against its plain version (``scatter_add_``) at the
   CVRP path's shape (B=100, L=1001, A=20, n=501, routes that K7 samples on
   ``1/d`` and that park on the depot) and at the main path's (K2's tours,
   B=100, N=500, A=20, cyclic): equal bits to ``scatter_add_`` on the CPU,
   equal bits on a second launch, and within the rounding of two sums in
   other orders (2k 2^-24 of an entry of k terms) of ``scatter_add_`` on
   the card; its time (the median of 5 means of 20 launches, timed in
   turns with ``torch.scatter_add``, which is timed the same way) must lie
   below ``torch.scatter_add``'s at both shapes; K7 on that rollout's own [2000, 501] score, depot and
   capacity mask and noise at four of its steps, actions exactly equal;
   K7c (``cvrp_construct``, the whole construction of an iteration) on
   ``1/d`` at the same shape, stochastic and greedy, paths bit-equal to its
   plain version's and valid, with its time and the bound of the steps the
   ants take; K6's forward at the CVRP inference shape (B=100, K = N = 501)
   against its plain version; K9 (``embnet_layers``, the CVRP
   heuristic's layer stack) on the golden set's dense graph (B=100, K = N
   = 501) against its plain version, the heuristic head's output at rtol
   1e-4 / atol 1e-5, as on the sparse path;
10. the CVRP path: ``evaluate_family("cvrp")`` with ``cvrp500_selftrained``
   on the golden CVRP500 set (100 instances, 500 customers, A=20, T=1 and
   10) in three arms: kernels (K9, K7c, K8), plain versions on the card
   (``embnet_layers_plain``, ``cvrp_construct_plain``, ``deposit_plain``),
   and classic (``1/d``: K7c, K8); per arm the costs, wall, phase times,
   the kernels' launches (K9 once, K6 and K7 never, K7c once an iteration)
   and the peak device memory. Every best route must be valid and cost what
   the run says; the kernel arm's cost@T1 must lie within 1e-4 of the plain
   arm's (the same Philox noise), its cost@T10 within 1% of the plain
   arm's, within 1% of the per-step construction's recorded 60.5116
   (``PER_STEP_CVRP_T10``) and below the classic arm's;
11. CVRP training at the CVRP500 envelope (``family_train_config("cvrp")``: 500
   customers, capacity 50, 50 ants, batch 1, lr 3e-4, the 12-layer Net on
   the dense graph, K = N = 501; nothing cut but the number of steps):
   (a) one step from the seed's weights on the first batch ``train_family``
   draws, the kernel arm (K6 a layer forward and backward, K7r) against the
   plain arm replaying its paths with the plain layer, held as in phase 7,
   every route valid and costing what the step reports; K6's forward and
   backward at B=1, K = N = 501 and K7r on the rollout's own inputs (50
   ants, 1,000 steps, capacity 50) against their plain versions; (b) three
   steps of ``make_family_train_step``, each with its loss, mean cost,
   gradient norm, wall, phase times and launches (counts set to 0 just
   before each step and read just after): exactly 12 K6 forward and 12
   backward launches and one K7r launch each way a step, no K7, K7c or K9
   launch, everything finite, the weights moved, and one more step under
   the profiler; (c) ``train_family`` cut to 2 steps with 4
   validation instances at T=2, its ``-best`` and ``-last`` checkpoints
   under ``build/chip_smoke/``, ``-last`` read back (``load_checkpoint``,
   ``family_model``) and evaluated; (d) ``cli.main(["test", "cvrp", "-n",
   "500", "-c", CVRP_CKPT, ...])`` on the card, whose costs must round to
   ``RECORDED_COSTS["cvrp"]`` (phase 10's kernel arm, through the CLI);
12. K9 (``embnet_layers``) against its plain version on the sparse path's
   own inputs (``tsp500_selftrained``, the CLI's 30 fixed-seed TSP2000
   instances, their k=200 support and neighbour distances, E=1), held on
   both heads' outputs at rtol 1e-4 / atol 1e-5 (sums in another order);
   row 9 (``tsp_sweep_construct``, K2 at B=1 with f32 scores) against
   ``dense_sweep`` on the main path's first instance (N=500, A=20): greedy
   tours exactly equal, stochastic ones permutations;
13. the sparse path: ``cli._cmd_test_tsp_sparse`` (``test tsp --sparse -n
   2000``, k=200, 20 ants, T=1 and 10) in a kernel arm (K9), a plain arm
   (``large_tsp.PLAIN_OPS``, same instances and seed), a classic arm
   (``1/d``) and a classic arm with ``--local-search 2opt`` (K4) on the
   first 4 instances at T=1 and 2; per arm the costs, the CLI's lines, wall,
   phase times, peak device memory, launches and the fallback and
   dropped-deposit rates. Every best tour must be a permutation costing
   what the run reports, and the kernel arm's cost@T1 must lie within 1e-4
   of the plain arm's (the same noise; only K9's rounding parts them);
14. the other families (``family_phase``), each at its largest golden
   scale with its largest checkpoint (12 layers, 32 units): OP300
   (``op300_selftrained``, 100 instances, max_len 6, k=30), PCTSP500 and
   SMTWTP500 (100 instances each, K = N = 501; SMTWTP without the node
   update), SOP100 (the masked dense graph, K = N = 100, no node update),
   BPP120 (K = N = 121, capacity 150) and MKP300 (K = N = 300, five node
   features; 100 instances each). K9 against its plain version on the
   family's graph, for BPP K7c on its neural score (paths bit-equal), for
   OP, PCTSP, SMTWTP, SOP and MKP K7r's
   untraced forward on one construction (``check_rollout_paths``: paths
   bit-equal to ``fused_rollout_paths_plain`` and to the traced forward,
   B=100, A=20), K8 on its routes (PCTSP's and BPP's parked on
   node 0, MKP's on the dummy item) held as in phase 9; the path
   (``evaluate_family``, A=20, T=1 and 10) in a kernel arm (K9 once, K7c
   10 or K7r's untraced forward 10, K7 never, K8 10), a plain arm on the card
   (``drivers.PLAIN_OPS``, the same generator seed) and a classic arm, each
   with its costs, wall, phase times, peak memory and launches; every best
   solution valid and scoring what the run says, the kernel arm's cost@T1
   within 1e-4 of the plain arm's, its cost@T10 within 1% of it and better
   than the classic arm's (higher for OP, BPP and MKP, which maximize), and
   the kernel arm's mean over seeds 0-7 (``JAX_SEEDS``; the 7 more runs
   through ``evaluate_family``) within 3% of the JAX package's at both T
   (``JAX_COSTS``); training at the
   family's envelope (``family_train_config``: OP300 and PCTSP500 with 20
   ants, SMTWTP500, SOP100 and MKP300 with 50, BPP120 with 120, batch 1,
   lr 3e-4): one step kernel arm against plain arm held as in phase 11, K6
   forward and backward on its graph and K7r on its rollout
   (``check_rollout``; BPP at capacity 150, OP300 and PCTSP500 at B=1, 20
   ants, SMTWTP, SOP and MKP at B=1, 50 ants), two steps of
   ``make_family_train_step`` with exactly 12 + 12 K6 and one K7r launch
   each way and no K7, K9, K7c or K8; and ``cli.main(["test", name, ...])``
   on the card, whose costs must
   be the kernel arm's;
15. CVRP-NLS500 (``cvrp_nls_phase``): ``cvrp_nls500_selftrained`` (12
   layers, 32 units, the two-block graph at k = 5) on the first 4 golden
   CVRP-NLS500 instances, 20 ants, T=1 and 10, seeds ``SEED + i``, the
   protocol of ``test cvrp --local-search swapstar``. The plain
   multi-block GNN pass timed at B=1 and B=4; K7c at capacity 1.0 on the
   neural scores (B=4, N=501; paths bit-equal to its plain version's), K7r
   at capacity 1.0 on instance 0's score (30 ants; as phase 7) and
   K8 on one instance's routes whose 8 cheapest ants the native engine
   rewrote (B=1, L=1001, A=20), held as in phase 9; the path through the
   CLI's own function in a kernel arm (K7c, K8: each once an iteration)
   and a plain arm on the first 2 instances, whose cost@T1 equals the
   kernel arm's per instance to the digit and whose cost@T10 lies within
   1%; the kernel arm within 2% of ``JAX_CVRP_NLS_COSTS`` (the JAX CLI on
   the same 4 instances) with the full set's anchors printed beside, every
   best route valid, each arm's phases (heuristic, construction, host
   copy, local search, update) and instance 0 once more under the
   profiler for the device's idle share; one training step at the
   CVRP500-NLS envelope (30 ants, lr 1e-4, AdamW decay 1e-4, the net in
   eval mode), K7c's paths against its plain version's and the two arms'
   steps on them under phase 7's tolerances, the running statistics
   unchanged; two steps of ``train_cvrp_nls``, saved and read back by the
   CLI;
16. MKP-items 500 (``family_phase`` with ``mkp_items``):
   ``mkp_items500_selftrained`` (the transformer) on the 100 golden
   instances, 20 ants, T=1 and 10: K7r's untraced forward (the ``"items"``
   kind: one score row an instance) on one construction's own inputs (B=100,
   A=20, N=501), the path in a kernel arm (K7r's untraced forward once an
   iteration, the vector pheromone, no K7, K8 or K9), a plain arm equal to
   it to the digit and a classic arm it beats at T10, within 3% of
   ``JAX_COSTS`` over 8 seeds (its idle share:
   ``scripts/profile_torch_main_path.py --family mkp_items``); training at
   the envelope (50 ants, lr 3e-4, AdamW decay 1e-2, clip 3.0): one step
   kernel arm against plain arm with K7r on its rollout (B=1, A=50), two
   steps of ``make_family_train_step`` (K7r once each way a step, nothing
   else), and the CLI's ``test``;
17. RCPSP j120 (``rcpsp_phase``): an archive of 104 seeded j120-shaped
   instances (``core.rcpsp.progen_rcp``: 122 activities, 4 resources,
   ProGen's RF 0.5 and RS 0.3) written under a temporary
   ``$DEEPACO_REFERENCE_ROOT``; K7r's untraced forward (SOP's kind on the
   direct evaluation's score and ``adj^T``) on one neural construction's
   own inputs (B=100, A=20, N=122) and K8 on the elitist update's two lists
   (directed), held as in phases 6 and 9; ``cli._cmd_test_rcpsp`` (``test
   rcpsp -n 120`` with ``rcpsp120_selftrained``, 20 ants, T=1 and 10) in a
   kernel, a plain (``drivers.PLAIN_OPS``), a classic and a ``--backfill``
   arm: every best schedule passes ``check_schedule`` and has the best
   makespan, the kernel arm's cost@T1 within 1e-4 of the plain arm's and
   cost@T10 within 1%, K7r's untraced forward 10 and K8 10 launches on the
   kernel, classic and backfill arms and nothing else; one training step
   (20 ants) kernel arm against plain arm as in phase 11, K7r on its
   rollout, then ``train rcpsp -n 120 -e 1 -s 2`` (K7r once each way a
   step, nothing else) and ``test rcpsp --ckpt`` of what it wrote; the
   kernel arm's first iteration once more under the profiler for the
   device's idle share; the blend (``RCPSPACO`` with gamma 0.5 and c 0.6 on
   the first test instance, 20 ants, T=2): K7 a step (242) and K8 2
   launches, nothing else, a feasible best schedule, and K7 on the rows of
   one more construction on its pheromone against its plain version;
18. ``test tsp`` on a golden file (``tsp_golden_phase``): the main path's
   first 16 instances written as ``tsp/testDataset-500.pt`` under a
   temporary ``$DEEPACO_REFERENCE_DATA``; K7r's untraced forward, K4, K5
   and K8 at the ACO facade's shapes (one instance, 20 ants, N=500, the NLS
   heuristic); four commands: the family path (``tsp500_selftrained``: K9
   once, K7r's untraced forward and K8 an iteration), ``--local-search
   nls`` batched (``tsp_nls500_selftrained``: K1, K2, K5, K3), the same
   ``--per-instance`` on the first 4 at T=1 and 2 (the facade: K1 once,
   K7r's untraced forward, K5 and K8 an iteration) and ``--local-search
   2opt --classic --per-instance`` (K7r untraced, K4, K8): every best tour
   a permutation, each command's launches as predicted, each one's peak
   memory, the per-instance NLS cost@T1 within 2% of the batched arm's on
   the same 4 instances; the family path's plain arm
   (``drivers.PLAIN_OPS``, the same noise): cost@T1 within 1e-4 and
   cost@T10 within 1% of the kernel arm's; the family path's first
   iteration under the profiler; then K7's route past K7r's caps
   (``k7_past_caps_run``): the ACO facade on one seeded TSP instance of
   4,608 nodes (20 ants, T=1, the classic heuristic, no local search): K7
   4,607 and K8 1 launches, nothing else, a best tour that is a permutation
   costing what the run reports, and K7 on the rows of one more
   construction against its plain version;
19. the remaining single-card paths (``remaining_phase``): (a)
   ``cvrp500_selftrained`` (with an extra head) and
   ``mkp_items500_selftrained`` written as reference-layout ``.pt`` files,
   ``test cvrp -n 500`` and ``test mkp_items -n 500`` through the CLI with
   ``--ckpt`` the ``.pt`` and the msgpack: equal cost lines, launches as on
   the family paths (K9 1, K7c 10, K8 10; K7r's untraced forward 10), and
   ``save_params_npz`` of the net read from the ``.pt`` holding the
   msgpack's names and arrays; (b) ``AdaptiveCVRPACO`` on the first 4
   golden CVRP500 instances (``1/d``, 20 ants, T=10, seeds 0-3) beside
   ``CVRPACO(elitist=True)``: cost@T10 at most 1.05x the elitist one,
   valid best routes that cost what the run reports, pools of 1-5, K7c 10
   an instance and K8 once an improving iteration; K7c at B=1 and K8 on its
   rewritten route against their plain versions; (c) ``run_anytime_sparse``
   at the main path's inputs on K1's heuristic (K1 1, K3 10, no K2) and
   its plain arm: cost@T1 within 1e-4, cost@T10 within 1% of each other
   and within 2% of the main path's recorded cost@T10, best tours
   permutations, the fallback share and the syncs' share of the wall, the
   first iteration under the profiler; K3 with the f32 score against its
   plain version; (d) ``make_mkp_items_train_step`` at MKP-items 500's
   envelope: the family loss it runs, kernel arm against plain arm held
   as in phase 7, then the step itself, K7r once each way in each and
   nothing else;
20. the multi-GPU paths (``parallel_phase``, ``parallel/``) at world size 1,
   a one-rank NCCL group and a 1 x 1 mesh (NCCL refuses two ranks on one
   card), and with two cards or more also one rank a card on a 2 x D/2 mesh
   (``_parallel_rank``, without the timings); the world sizes that ran on a
   line of their own first. ``parallel_checks``: (a)
   ``sharded_embnet_forward`` on the sparse path's first TSP2000 instance
   (k = 200, ``tsp500_selftrained``) in eval and train mode against the
   unsharded ``EmbNet`` with the plain layer (within 1e-4 of the largest
   entry), 12 K6 row-shard launches a call and nothing else, the running
   statistics untouched; K6 on a row shard (R = N/4 = 500 against the N =
   2000 tables, and the rank's own shard) against its plain version at rtol
   1e-5 / atol 1e-5; ``edges_per_second_bench`` there and at bench.py's
   anchor shape (N = 2048, K = 32); (b) ``make_sharded_tsp_train_step`` at
   TSP500 (the main path's first 4 instances, 20 ants): one step on tours
   sampled once on the starting weights against the unsharded step from the
   same weights (loss and gradient norm rtol 1e-5, gradients within 1e-5 of
   the largest entry, running statistics rtol 1e-5, the weights bit-equal on
   every rank), then 2 sampled steps of 12 + 12 K6 and one K7r launch each
   way and no K7 each; K7r on the step's rollout (4 x 20 ants, N=500); (c) ``evaluate_family("cvrp",
   mesh=)`` on the golden CVRP500 set, T=1 and 10: equal to the rank's block
   run alone with its ``block_seed``, its costs ``RECORDED_COSTS["cvrp"]``
   at world size 1, every best route valid, K9 1, K7c 10, K8 10; (d)
   ``multi_colony_tsp_search`` on the main path's first instance with K1's
   heuristic (20 ants, 5 rounds of 2 iterations, ``migrate_weight=1``,
   ``blend=0.25``): a monotone curve, the same on every rank, its first and
   last cost ``RECORDED_COSTS["island"]``, K7r's untraced forward 10, K7
   none and K8 15, its peak memory; without
   migration and blend each round equal to the best of the colonies run
   alone with ``colony_seed``; K8 at the migration's shape (B=1, L=500,
   A=1) held as in phase 9;
21. ``{"kernels": [...]}``: per kernel its launches (K1-K3 from the main
   path, K4 from the 2-opt arm, K5 from the NLS arm, K6 and K7r (forward
   ``fused_rollout``, backward ``fused_rollout_backward``) from the
   TSP500-NLS training run, K7r's untraced forward (``fused_rollout_paths``)
   from phase 18's family path, K7 from phase 18's run past K7r's caps, K7c
   and K8 from the CVRP path's kernel arm, K9 from the sparse and the CVRP
   paths' kernel arms together; row 9 is on no path of either package, so
   its count is 0), error, times and bound; K7r's entries carry ``tsp500``,
   ``bpp``, ``cvrp_nls``, ``mkp_items``, ``rcpsp``, ``rcpsp_blend`` and
   ``parallel`` too (their launches in that path's training and, untraced,
   on its kernel
   arm, with their error, times and bound at its shapes); K6's and K7r's
   entries also
   carry ``cvrp_train``: their launches in phase 11's three steps and their
   times, error and bound at its shapes; K6,
   K7, K8 and K9 carry ``op``, ``pctsp``, ``smtwtp``, ``sop``, ``bpp`` and
   ``mkp`` (K7c ``bpp``): their launches on that family's kernel arm (K7, K7c or K7r
   untraced, K8, K9) and in its two training steps (K6, K7 or K7r), with
   their error, times and bound at its shapes; K7r's untraced forward
   (``fused_rollout_paths``: SMTWTP500's inference shape, its launches from
   phase 18's family path) carries ``op``, ``pctsp``, ``smtwtp``, ``sop``,
   ``mkp``, ``mkp_items`` and ``rcpsp``; K7c and K8 carry ``cvrp_nls`` the
   same way; K7 (its launches from the run past K7r's caps) carries
   ``past_caps`` (its launches, error, times and bound on that run's rows)
   and ``rcpsp`` and ``rcpsp_blend`` (0 on RCPSP's paths and training); K7r's
   untraced forward's ``rcpsp_blend`` holds the blend run's launches and
   its check there, K7r's ``rcpsp_blend`` the blend step's; K8
   ``rcpsp``, K7r untraced, K8, K4 and K5 ``tsp_facade``; phase 19's
   launches: K1 and K3 ``sparse_runner`` (K3 also its f32-score times), K9,
   K7c, K8 and K7r untraced ``reference_pt``, K7c and K8 ``adaptive_cvrp``
   (with their times at its shapes), K7r ``mkp_items_step``; phase 20's
   under ``parallel``: K6's row-shard
   launches, its launches in a sharded step and its time, error and bound
   on the row shard; K6 backward's and K7's in a sharded step, K7r
   untraced's in the island search; K8's on ``evaluate_family(mesh=)``
   and in the island search with its time at the migration's shape; K7c's
   and K9's on ``evaluate_family(mesh=)``; each with the world sizes that
   ran.

Every path's cost (main cost@T10, NLS, CVRP, sparse, OP, PCTSP, SMTWTP,
SOP, BPP, MKP, CVRP-NLS, MKP-items, RCPSP (kernel and backfill arms), the four
``test tsp`` commands', the adaptive and elitist CVRP baselines' and the sparse
runner's cost@T1 and cost@T10, the island search's first and last round,
and both for the plain arms of the main, NLS and sparse paths and the
sparse runner) must equal the one recorded in ``RECORDED_COSTS`` to the 4 decimals
recorded: the kernels are exact or held to their plain versions, and the
inputs and seeds are fixed. K1's and K9's ``{"phase": "kernel"}`` lines
also carry ``design_floor_ms``, the time their streamed edge state takes
at the memory rate, computed from the shapes. Then the ``nvidia-smi`` line
again and, last, ``{"ok": true, "device": ...}``.
Any failed check exits non-zero. Without a CUDA device it exits 1 at once.

``--parallel-only`` runs the build and phase 20 alone, held to the same
checks and to ``RECORDED_COSTS["cvrp"]`` and ``["island"]``, then the
``nvidia-smi`` line and the ``ok`` line: the short run of the multi-card
paths (on four cards, a 2 x 2 mesh).
"""
from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

N, K, A, B, T_VALUES, SEED = 500, 50, 20, 100, (1, 10), 0
CKPT = "checkpoints/tsp500_selftrained.msgpack"
NLS_CKPT = "checkpoints/tsp_nls500_selftrained.msgpack"
B_NLS, N_LARGE, LS_BUDGET = 16, 1100, 10000
B_TRAIN, A_TRAIN_NLS, A_TRAIN = 20, 30, 50     # the training envelopes (A_TRAIN: TSP500, CVRP500)
TRAIN_STEPS = {"tsp500": 4, "tsp500_nls": 2}
CVRP_TRAIN_STEPS, CVRP_VAL_B = 3, 4             # make_family_train_step's run; validation cut
CVRP_N, CVRP_CKPT = 500, "checkpoints/cvrp500_selftrained.msgpack"
# each family path's scale, checkpoint (the largest committed), and its
# training envelope from RESULTS.md:164, 170-171, 175-181: ants, epochs,
# steps an epoch
FAMILY_PATHS = {"cvrp": (CVRP_N, CVRP_CKPT, A_TRAIN, 5, 128),
                "op": (300, "checkpoints/op300_selftrained.msgpack", 20, 15, 64),
                "pctsp": (500, "checkpoints/pctsp500_selftrained.msgpack", 20, 15, 128),
                "smtwtp": (500, "checkpoints/smtwtp500_selftrained.msgpack", 50, 5, 128),
                "sop": (100, "checkpoints/sop100_selftrained.msgpack", 50, 5, 128),
                "bpp": (120, "checkpoints/bpp120_selftrained.msgpack", 120, 5, 64),
                "mkp": (300, "checkpoints/mkp300_selftrained.msgpack", 50, 10, 64),
                "mkp_items": (500, "checkpoints/mkp_items500_selftrained.msgpack", 50, 5, 256)}
# phase 14's families, in order; BPP constructs through K7c in inference,
# the others (and phase 16's MKP-items) through K7r's untraced forward, and
# every family's training rollout takes K7r (the plug-ins carry ``fused``)
FAMILY_PHASE = ("op", "pctsp", "smtwtp", "sop", "bpp", "mkp")
ONE_PASS = ("bpp",)
FAMILY_TRAIN_STEPS = 2
FAMILY_PICK_AT = (0.0, 1 / 3, 2 / 3)    # K7's checks on their rows, as shares of the horizon
# the JAX package's costs at T1 and T10 (RESULTS.md:164, 170-171, 175, 178,
# 179): quality anchors, not speed targets; each kernel arm's mean over
# JAX_SEEDS seeds lies within JAX_COST_SPAN of them
JAX_COSTS = {"op": (72.78, 80.08), "pctsp": (16.20, 15.70), "smtwtp": (0.662, 0.572),
             "sop": (71.67, 70.46), "bpp": (0.9542, 0.9586), "mkp": (58.2, 59.3),
             "mkp_items": (98.92, 99.99)}
JAX_COST_SPAN, JAX_SEEDS = 0.03, 8
# phase 15, CVRP-NLS500: the checkpoint, the first CVRP_NLS_B golden
# instances (the plain arm on the first CVRP_NLS_PLAIN_B); the JAX CLI's
# means on those 4 instances (`python -m deepaco_tpu test cvrp -n 500
# --local-search swapstar --ckpt CVRP_NLS_CKPT --limit 4 -t 1 10`, on a CPU),
# which the kernel arm lies within CVRP_NLS_SPAN of, and the full set's
# anchors (RESULTS.md:191), printed beside them; the training envelope
# (RESULTS.md:191): ants, lr, epochs, steps an epoch
CVRP_NLS_N, CVRP_NLS_CKPT = 500, "checkpoints/cvrp_nls500_selftrained.msgpack"
CVRP_NLS_B, CVRP_NLS_PLAIN_B = 4, 2
JAX_CVRP_NLS_COSTS, CVRP_NLS_SPAN = (33.4715, 33.0899), 0.02
CVRP_NLS_ANCHORS = (30.160, 29.846)
CVRP_NLS_TRAIN = (30, 1e-4, 15, 20)
CVRP_NLS_TRAIN_STEPS = 2
CVRP_PICK_AT = (0.0, 0.15, 0.4, 0.7)   # K7's CVRP checks, as shares of the horizon
# phase 17, RCPSP j120: the archive the smoke writes (RCPSP_INSTANCES seeded
# instances, the first 100 the test split, the other 4 the train split), the
# checkpoint, the CLI's training cut to RCPSP_TRAIN_STEPS steps
RCPSP_N, RCPSP_CKPT = 120, "checkpoints/rcpsp120_selftrained.msgpack"
RCPSP_INSTANCES, RCPSP_TRAIN_STEPS = 104, 2
# the blend (gamma >= 0.05, c < 1), K7r's "blend" kind: RCPSPACO on the
# first test instance, RCPSP_BLEND_T iterations, and one rcpsp_loss step
RCPSP_BLEND, RCPSP_BLEND_T = {"gamma": 0.5, "c": 0.6}, 2
# K7's route past K7r's caps: the ACO facade on one seeded U(0,1)^2 TSP
# instance of K7_PAST_N > FUSED_ROLLOUT_MAX_N nodes, A ants, K7_PAST_T
# iterations, the classic heuristic, no local search
K7_PAST_N, K7_PAST_T = 4608, 1
# phase 18, test tsp on the golden file the smoke writes: the main path's
# first TSP_GOLDEN_B instances; the per-instance arms on the first TSP_PER_B
# at TSP_PER_T
TSP_GOLDEN_B, TSP_PER_B, TSP_PER_T = 16, 4, (1, 2)
ADAPTIVE_B = 4          # phase 19: the golden CVRP500 instances of the adaptive baseline
SPARSE_N, SPARSE_B, SPARSE_LS_B = 2000, 30, 4    # the CLI's TSP2000 set; 2-opt arm's cut
SPARSE_T, SPARSE_LS_T = (1, 10), (1, 2)
# each path's cost@T1 and cost@T10 as recorded on an NVIDIA H100 80GB HBM3
# (None: not recorded), through the kernels and, for the main, NLS and sparse
# paths, through the plain versions (no kernel runs there); the inputs and
# seeds are fixed and the kernels exact or held to their plain versions, so
# they reproduce to the digit
RECORDED_COSTS = {"main": (None, 19.6391), "main_plain": (20.6735, 19.6335),
                  "nls": (17.1227, 16.9536), "nls_plain": (17.1133, 16.9749),
                  "cvrp": (61.7577, 60.5177),
                  "sparse": (48.2913, 45.1827), "sparse_plain": (48.2913, 45.1980),
                  "op": (73.2084, 80.1825), "pctsp": (16.2131, 15.7105),
                  "smtwtp": (0.6824, 0.5497), "sop": (72.2384, 70.8659),
                  "bpp": (0.9544, 0.9588), "mkp": (58.1421, 59.3408),
                  "cvrp_nls": (33.2462, 33.0091), "mkp_items": (98.8829, 99.9512),
                  "rcpsp": (136.82, 130.13), "rcpsp_backfill": (103.08, 100.17),
                  "tsp_family": (20.883, 19.8193), "tsp_nls_batched": (17.1227, 16.9536),
                  "tsp_nls_per_instance": (17.1562, 17.0908),
                  "tsp_2opt_per_instance": (17.8571, 17.7711),
                  "adaptive_cvrp": (133.0119, 128.2005), "elitist_cvrp": (189.5996, 182.5418),
                  "sparse_runner": (20.8735, 19.767), "sparse_runner_plain": (20.8735, 19.7675),
                  "island": (20.6805, 20.1142)}
# the CVRP kernel arm's cost@T10 as recorded through the per-step
# construction (K7 a step, torch.rand noise); the one-pass construction
# samples the same law and is held within 1% of it
PER_STEP_CVRP_T10 = 60.5116
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
# f32 products on the tensor cores as three TF32 products (495 TFLOP/s dense)
TF32X3_OPS_PER_S = 495e12 / 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(bytes_moved: float, ops: float, product_ops: float = 0.0) -> tuple[float, str]:
    """The least time for the work: its bytes at the memory rate, or its
    f32 operations, ``product_ops`` of them in matrix products that the
    tensor cores can take in 3xTF32 and the rest at the f32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S + product_ops / TF32X3_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def k3_work(b: int, n: int, a: int, score_bytes: int) -> tuple[float, float]:
    """K3's bytes and f32 operations for ``bound``: tau and log_heu read once,
    tau' and the score (``score_bytes`` an entry) written once, the B*A*N
    distances of the tours' edges, the tours at 4 bytes a city id, the costs,
    the best cost and tour read and written; the update's multiply and add,
    the score's clamp, log, multiply and add, and each edge's cost and two
    deposit adds."""
    nbytes = (4 * 3 + score_bytes) * b * n * n + 4 * b * a * n + 4 * b * n * a + 4 * b * a \
        + 2 * 4 * (b + b * n)
    return nbytes, 6 * b * n * n + 3 * b * a * n


def k6_forward_work(b: int, r: int, n: int, k: int, u: int, write_pre: bool = True):
    """K6's forward bytes, f32 operations and tensor-core product operations
    for ``bound`` over ``b`` instances of ``r`` rows (``n`` nodes): w and
    pre, x2 and x4 (``n`` rows), x3 and agg (``r`` rows), nbr (int32), ew,
    eb; the edge product (2 U^2 an edge, 3xTF32) and the gate, mean and sums
    (5 U an edge). Without pre (row 8): w, x2, agg and nbr; the gate,
    product and sum (4 U an edge)."""
    edges = b * r * k
    if not write_pre:
        return 4 * (edges * u + b * n * u + b * r * u) + 4 * edges, 4 * edges * u, 0
    return (4 * (2 * edges * u + 2 * b * n * u + 2 * b * r * u + edges + u * u + u),
            5 * edges * u, 2 * edges * u * u)


def k6_backward_work(b: int, n: int, k: int, u: int):
    """K6's backward bytes, f32 operations and tensor-core product
    operations for ``bound``: w, d_pre, x2, d_agg, nbr and the reverse
    adjacency in; d_w, d_x2, d_x3, d_x4, d_ew, d_eb out; d_pre @ ew^T (2 U^2
    an edge, 3xTF32), w^T d_pre (2 U^2 an edge, f32, a PyTorch product) and
    about 10 U an edge for the gate, sums and scatters."""
    edges = b * n * k
    return (4 * (3 * edges * u + 5 * b * n * u + 2 * edges + b * (n + 1) + 2 * u * u + 2 * u),
            2 * edges * u * u + 10 * edges * u, 2 * edges * u * u)


def k9_work(b: int, n: int, k: int, e: int, layers: int, u: int):
    """K9's bytes, f32 operations and tensor-core product operations for
    ``bound``, and the bytes its design streams: e_lin0 (E multiply-adds and
    a SiLU, about 5 operations, a feature), each layer's node pass (2 U 4U a
    node) and about 10 U an edge for the gate, the sums, the affine, SiLU
    and residual; the per-edge 32x32 products (2 U^2) at the tensor cores'
    3xTF32 rate; bytes: edge features, int32 ids and x in, the edge state
    out. The design writes the edge state in e_lin0, then each layer reads
    and writes it once."""
    edges = b * n * k
    ops = edges * u * (2 * e + 5) + layers * (2 * b * n * u * 4 * u + edges * 10 * u)
    nbytes = 4 * (edges * e + edges + b * n * u + edges * u)
    floor_bytes = 4 * (edges * e + edges * u * (1 + 2 * layers))
    return nbytes, ops, layers * edges * 2 * u * u, floor_bytes


def main_path_inputs(root: Path, dev, ls: str | None = None):
    """The path's weights (``tsp500_selftrained``, or ``tsp_nls500_selftrained``
    when ``ls`` is set) and its seeded instances of N uniform cities (B of
    them, or the first B_NLS with ``ls``)."""
    import torch

    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    ckpt = CKPT if ls is None else NLS_CKPT
    net = Net.from_jax_variables(load_checkpoint(str(root / ckpt))).to(dev)
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED), batch=B,
                            device=dev)
    return net, coords if ls is None else coords[:B_NLS]


def drive(net, coords, ops=None, ls: str | None = None):
    """One call of the paths' entry point, ``evaluate_tsp`` (``net=None`` is
    the classic arm, ``ls`` the local search); ``ops`` swaps in the plain
    versions or a timer."""
    from deepaco_tpu_torch.aco.batched_tsp import KERNEL_OPS
    from deepaco_tpu_torch.aco.runner import ACOConfig
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp

    return evaluate_tsp(coords, net=net, k_sparse=K, cfg=ACOConfig(n_ants=A),
                        t_values=T_VALUES, seed=SEED, ls=ls,
                        _ops=ops or KERNEL_OPS)


def family_inputs(root: Path, dev, name: str = "cvrp"):
    """A family path's weights (its largest checkpoint: 12 layers, 32 units;
    CVRP's ``cvrp500_selftrained`` with demand as the node feature) and its
    golden set at that scale (numpy)."""
    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train.drivers import family_model
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.golden import GOLDEN

    n, ckpt = FAMILY_PATHS[name][:2]
    net = family_model(get_family(name), load_checkpoint(str(root / ckpt)))
    return net.to(dev), GOLDEN[name](n)


def drive_family(net, ds, ops=None, name: str = "cvrp", seed: int = SEED):
    """One call of a family path's entry point, ``evaluate_family`` (``net=None``
    is the classic arm); returns ``(means, curves, final state)``."""
    from deepaco_tpu_torch.train.drivers import KERNEL_OPS, evaluate_family

    return evaluate_family(name, ds, n_nodes=FAMILY_PATHS[name][0], net=net, n_ants=A,
                           t_values=T_VALUES, seed=seed, return_state=True,
                           _ops=ops or KERNEL_OPS)


def valid_solutions(name: str, paths, inst):
    """Each solution's feasibility ``[B, A]`` by the family's validator, on
    the prepared instance."""
    from deepaco_tpu_torch.aco.problems.bpp import validate_bpp
    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
    from deepaco_tpu_torch.aco.problems.mkp import validate_mkp
    from deepaco_tpu_torch.aco.problems.op import validate_op
    from deepaco_tpu_torch.aco.problems.pctsp import validate_pctsp
    from deepaco_tpu_torch.aco.problems.smtwtp import validate_smtwtp
    from deepaco_tpu_torch.aco.problems.sop import validate_sop
    from deepaco_tpu_torch.families import BPP_CAPACITY, CVRP_CAPACITY

    if name == "cvrp":
        return validate_routes(paths, inst["demand"], CVRP_CAPACITY)
    if name == "op":
        return validate_op(paths, inst["dist"], inst["max_len"])
    if name == "pctsp":
        return validate_pctsp(paths, inst["prizes"], (inst["prizes"].shape[-1] - 1) / 4.0)
    if name == "sop":
        return validate_sop(paths, inst["prec"])
    if name == "bpp":
        return validate_bpp(paths, inst["demand"], BPP_CAPACITY)
    if name == "mkp":
        return validate_mkp(paths, inst["weight"], inst["prize"].shape[-1] // 2)
    if name == "mkp_items":
        return validate_mkp(paths, inst["weight"], 1.0)
    return validate_smtwtp(paths)


def sparse_args(root: Path, *extra: str, t_values=None, limit: int | None = None):
    """The CLI's arguments for the sparse path at TSP2000 (k = n/10 = 200) on
    its first ``limit`` instances (all 30 by default): the neural arm with
    ``tsp500_selftrained`` unless ``extra`` says ``--classic``."""
    from deepaco_tpu_torch import cli

    argv = ["test", "tsp", "--sparse", "-n", str(SPARSE_N), "-a", str(A),
            "--seed", str(SEED), "-t", *map(str, t_values or SPARSE_T), *extra]
    if "--classic" not in extra:
        argv += ["--ckpt", str(root / CKPT)]
    argv += ["--limit", str(limit or SPARSE_B)]
    return cli.build_parser().parse_args(argv)


def sparse_inputs(root: Path, dev):
    """K9's inputs on the sparse path: the weights and the graph over the
    CLI's 30 fixed-seed instances (coordinates, k-NN support, neighbour
    distances)."""
    import numpy as np
    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.large_tsp import knn_support, sparse_tsp_graph
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    net = Net.from_jax_variables(load_checkpoint(str(root / CKPT))).to(dev).eval()
    coords = torch.as_tensor(np.random.default_rng(cli.SPARSE_SEED).random(
        (SPARSE_B, SPARSE_N, 2)).astype(np.float32), device=dev)
    return net, sparse_tsp_graph(coords, knn_support(coords, SPARSE_N // 10))


def drive_sparse(args, ops=None, stats: dict | None = None):
    """One call of the sparse path's entry point, ``cli._cmd_test_tsp_sparse``;
    returns ``(means, curves, the CLI's printed lines)``."""
    import io

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.large_tsp import KERNEL_OPS

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        means, curves = cli._cmd_test_tsp_sparse(args, stats=stats, _ops=ops or KERNEL_OPS)
    return means, curves, out.getvalue().splitlines()


def check_embnet_layers(cuda_ms, net, g, config: str) -> dict:
    """K9 against its plain version on a path's own inputs (``config``: the
    sparse path's graph, or the CVRP path's dense one), on every head of
    ``net``; emits its line and returns K9's entry of the kernels' line."""
    import torch

    from deepaco_tpu_torch.ops import fused_gnn

    f = fused_gnn.fold_embnet_params(net.emb_net)
    x = fused_gnn._node_embedding(f, g.x)
    b, n, k = g.nbr.shape
    e, layers, u = g.edge.shape[-1], f.bv.shape[0], net.emb_net.units
    heads = ("phe", "heu") if net.dual_heads else ("heu",)

    def outputs(stack):
        out = fused_gnn.net_forward_fast(net, g.x, g.nbr, g.edge, heads=heads, layers=stack)
        return out if isinstance(out, tuple) else (out,)

    with torch.no_grad():
        got, want = outputs(fused_gnn.embnet_layers), outputs(fused_gnn.embnet_layers_plain)
        ok = all(bool(torch.allclose(a, r, rtol=1e-4, atol=1e-5)) for a, r in zip(got, want))
        err = max((a - r).abs().max().item() for a, r in zip(got, want))
        # the score reads log(heu + 1e-10)
        log_err = ((got[-1] + 1e-10).log() - (want[-1] + 1e-10).log()).abs().max().item()
        score_flips = ((got[-1] + 1e-10).log().to(torch.bfloat16)
                       != (want[-1] + 1e-10).log().to(torch.bfloat16)).float().mean().item()
        del got, want
        nu = net.emb_net.node_update
        ms = cuda_ms(lambda: fused_gnn.embnet_layers(f, x, g.nbr, g.edge, k=k, node_update=nu), 3)
        plain_ms = cuda_ms(lambda: fused_gnn.embnet_layers_plain(f, x, g.nbr, g.edge, k=k,
                                                                 node_update=nu), 1)
    nbytes, ops, product_ops, floor_bytes = k9_work(b, n, k, e, layers, u)
    emit({"phase": "kernel", "name": "embnet_layers", "config": config, "B": b, "N": n,
          "K": k, "E": e, "layers": layers, "node_update": nu, "passed": ok, "max_abs_err": err,
          "max_log_heu_err": log_err, "bf16_score_entries_differing": score_flips,
          "ms": ms, "plain_ms": plain_ms,
          "design_floor_ms": floor_bytes / HBM_BYTES_PER_S * 1e3,
          "tolerance": f"heads {heads} rtol 1e-4, atol 1e-5 (sums in another order over "
                       "12 layers)"})
    return {"name": "embnet_layers", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/embnet_layers.cu",
            "replaces": "deepaco_tpu/ops/fused_gnn.py:242",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
            "passed": ok, **dict(zip(("bound_ms", "bound_by"), bound(nbytes, ops, product_ops)))}


def check_row9(dev, cuda_ms, score) -> dict:
    """Row 9, ``tsp_sweep_construct`` (K2 at B=1, f32 scores), against
    ``dense_sweep`` on one instance's ``score [N, N]``: greedy tours exactly
    equal, stochastic tours permutations from their starts."""
    import torch

    from deepaco_tpu_torch.aco import batched_tsp as bt

    n = score.shape[0]
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    start = torch.randint(0, n, (A,), generator=gen, device=dev)
    greedy = bt.tsp_sweep_construct(score, start, gen, stochastic=False)
    want = bt.dense_sweep(score[None], start[None], gen, stochastic=False)[0]
    paths = bt.tsp_sweep_construct(score, start, gen)
    perms = bool(torch.equal(torch.sort(paths, dim=0).values,
                             torch.arange(n, device=dev)[:, None].expand(n, A)))
    ok = bool(torch.equal(greedy, want)) and perms and bool(torch.equal(paths[0], start))
    ms = cuda_ms(lambda: bt.tsp_sweep_construct(score, start, gen), 10)
    plain_ms = cuda_ms(lambda: bt.dense_sweep(score[None], start[None], gen)[0], 1)
    emit({"phase": "kernel", "name": "tsp_sweep_construct", "N": n, "A": A, "passed": ok,
          "greedy_equal": bool(torch.equal(greedy, want)), "permutations": perms,
          "ms": ms, "plain_ms": plain_ms,
          "tolerance": "greedy tours exact; stochastic tours permutations"})
    return {"name": "tsp_sweep_construct", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/sweep.cu (K2 at B=1, f32 scores)",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:606",
            "max_abs_err": (greedy - want).abs().max().item(), "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "passed": ok,
            # f32 scores, starts and int32 tours; a select, an add and a
            # compare per candidate column of each step
            **dict(zip(("bound_ms", "bound_by"), bound(4 * n * n + 4 * A + 4 * n * A,
                                                        2 * A * (n - 1) * n)))}


def cvrp_rollout(dev, ds):
    """One CVRP rollout on ``1/d`` at the path's shape (B=100, A=20, n=501),
    each step through K7; returns its paths, their ``1/cost`` amounts and the
    pick's inputs ``(step, score, mask, noise)``, [B*A, n] each, at the
    shares CVRP_PICK_AT of the horizon."""
    import torch

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost
    from deepaco_tpu_torch.families import CVRP_CAPACITY
    from deepaco_tpu_torch.ops import pick

    dist = torch.as_tensor(ds["dist"], device=dev)
    demand = torch.as_tensor(ds["demand"], device=dev)
    spec = cvrp_spec(torch.ones_like(dist), 1.0 / dist, demand, CVRP_CAPACITY, A)
    at = {int(f * spec.horizon) for f in CVRP_PICK_AT}
    steps = iter(range(spec.horizon))
    captured = []

    def capture(score, mask, noise):
        step = next(steps)
        if step in at:
            captured.append((step, score.clone(), mask.clone(), noise.clone()))
        return pick.fused_pick(score, mask, noise)

    paths = rollout(spec, torch.Generator(device=dev).manual_seed(SEED + 5),
                    pick=capture).paths
    return paths, 1.0 / route_cost(dist, paths), captured


def check_pick_rows(cuda_ms, captured, shares=CVRP_PICK_AT) -> dict:
    """K7 against its plain version on a rollout's own score, mask (CVRP's
    depot and capacity, OP's budget and dummy node, PCTSP's gate and
    parking) and noise at the steps of ``shares`` of its horizon: actions
    exactly equal and allowed, logp rtol 1e-5 / atol 1e-5."""
    import torch

    from deepaco_tpu_torch.ops import pick

    steps, ok, err = [], True, 0.0
    with torch.no_grad():
        for s, score, mask, noise in captured:
            act_k, logp_k = pick.fused_pick(score, mask, noise)
            act_p, logp_p = pick.fused_pick_plain(score, mask, noise)
            equal = bool(torch.equal(act_k, act_p))
            close = bool(torch.allclose(logp_k, logp_p, rtol=1e-5, atol=1e-5))
            allowed = bool((mask.gather(1, act_k[:, None]) > 0).all())
            open_cols = mask.sum(1)
            steps.append({"step": s, "actions_equal": equal, "logp_close": close,
                          "actions_allowed": allowed,
                          "open_per_row": [int(open_cols.min()), int(open_cols.max())],
                          "logp_max_abs_err": (logp_k - logp_p).abs().max().item()})
            ok &= equal and close and allowed
            err = max(err, steps[-1]["logp_max_abs_err"])
        _, score, mask, noise = captured[len(captured) // 2]
        ms = cuda_ms(lambda: pick.fused_pick(score, mask, noise), 50)
        plain_ms = cuda_ms(lambda: pick.fused_pick_plain(score, mask, noise), 20)
    rows, n = score.shape
    return {"rows": rows, "N": n, "passed": len(captured) == len(shares) and ok,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "steps": steps,
            **dict(zip(("bound_ms", "bound_by"), bound(3 * 4 * rows * n + 12 * rows,
                                                        6 * rows * n)))}


ROLLOUT_TOLERANCE = ("paths exact; log_probs rtol 1e-5, atol 1e-6 (K7's limit: logsumexp order, "
                     "expf/logf against torch's); d_score rtol 1e-4, atol 1e-5 of its largest "
                     "entry (K6's limit: softmax and sum order), a repeat and autograd through "
                     "the wrapper bit-equal to the entry")


@contextlib.contextmanager
def captured_rollouts(store: list):
    """While open, the engine's one-launch routes for ``fused_pick`` (with
    log-probabilities and without) record K7r's inputs ``(score, start,
    noise, shape)`` in ``store`` and then launch K7r as before."""
    from deepaco_tpu_torch.aco import engine
    from deepaco_tpu_torch.ops import pick

    routes = engine._FUSED[pick.fused_pick]

    def capturing(route):
        def capture(score, start, noise, shape):
            store.append((score.detach(), start, noise, shape))
            return route(score, start, noise, shape)
        return capture

    engine._FUSED[pick.fused_pick] = tuple(capturing(r) for r in routes)
    try:
        yield store
    finally:
        engine._FUSED[pick.fused_pick] = routes


def rollout_work(score, noise, shape, paths, traced: bool = True):
    """K7r's bytes and f32 operations for ``bound``, forward and backward,
    over the steps this run's ants take (a CVRP ant stops once back at the
    depot with every customer served, a PCTSP ant once back at the depot,
    an MKP, MKP-items or OP ant once on the dummy: their later picks are
    certain). Forward: the score (MKP-items: its one row an instance), those
    steps' noise, the starts and the plug-in's own input (CVRP's demands,
    SOP's precedence bytes and predecessor counts, MKP's and MKP-items'
    weights, OP's distances and budgets, PCTSP's prizes) read, paths
    and (traced) log-probabilities written; a select, compare, exp and add
    for the logsumexp and an add and compare for the maximum a column a
    step, MKP's add and compare a dimension, OP's two adds and a compare.
    Backward: score, g and paths read, d_score written; an exp, subtract,
    multiply and add a column a step."""
    import torch

    b, n = score.shape[0], score.shape[-1]
    score_bytes = 4 * score.numel()
    t, _, a, _ = noise.shape
    if shape.kind in ("cvrp", "mkp", "items", "op", "pctsp"):
        idx = torch.arange(1, t + 1, device=paths.device)[None, :, None]
        if shape.kind == "cvrp":
            last = ((paths[:, 1:] != 0) * idx).amax(dim=1)   # the last customer's index
            steps = int((last + 1).clamp(max=t).sum())
        else:                                        # the first dummy (depot) pick's index
            park = 0 if shape.kind == "pctsp" else shape.dummy
            first = torch.where(paths[:, 1:] == park, idx, t + 1).amin(dim=1)
            steps = int(first.clamp(max=t).sum())
    else:
        steps = b * a * t
    own = {"cvrp": 4 * b * n, "sop": b * n * n + 4 * b * n,
           "mkp": 0 if shape.weight is None else 4 * shape.weight.numel(),
           "items": 0 if shape.weight is None else 4 * shape.weight.numel(),
           "op": 4 * b * n * n + 4 * b, "pctsp": 4 * b * n,
           "blend": b * n * n + 4 * b * n + 2 * score_bytes}.get(shape.kind, 0)
    dims = 2 * shape.weight.shape[-1] if shape.weight is not None else 0
    # the blend: the running sum's multiply and add, the power, the products
    # with heu_pow, c and 1 - c, their sum, the compare, the max and the log
    ops = 6 + {"mkp": dims, "items": dims, "op": 3, "blend": 9}.get(shape.kind, 0)
    out_bytes = 8 * b * (t + 1) * a + (4 * b * t * a if traced else 0)
    fwd = (score_bytes + 4 * steps * n + 8 * b * a + own + out_bytes, ops * steps * n)
    bwd = (2 * score_bytes + 4 * b * t * a + 8 * b * (t + 1) * a, 4 * steps * n)
    if shape.kind == "blend":
        # P, heu_pow and phe read, their three gradients written; the running
        # sum replayed, p recomputed and its three terms and the adjoint a
        # column a step
        bwd = (6 * score_bytes + 4 * b * t * a + 8 * b * (t + 1) * a, 20 * steps * n)
    return fwd, bwd, steps


def kernel_device_ms(fn, names, reps: int = 5) -> dict:
    """``fn()`` ``reps`` times under ``torch.profiler``: the device time of
    a launch of each kernel whose name holds one of ``names``, in ms, from
    the kernels on the card's timeline as ``device_busy`` reads them: their
    total over the launches the trace holds (it may hold fewer than
    ``reps``), or "not measured" where it holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, seen = {name: 0.0 for name in names}, {name: 0 for name in names}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            for name in names:
                if name in ev.name:
                    total[name] += ev.time_range.elapsed_us() / 1e3
                    seen[name] += 1
    return {k: total[k] / seen[k] if seen[k] else "not measured" for k in names}


def check_rollout(cuda_ms, score, start, noise, shape, config: str) -> dict:
    """K7r on a rollout's own inputs (``score [B, N, N]``, MKP-items' ``[B,
    N]``, ``start [B, A]``, ``noise [T, B, A, N]``, the plug-in's shape): the forward against
    ``fused_rollout_plain`` on the same noise, the backward on one cotangent
    against ``rollout_backward_plain`` (ROLLOUT_TOLERANCE), a repeat of the
    backward and autograd through ``fused_rollout`` bit-equal to it; each
    direction's time by CUDA events and by the profiler's device time, the
    plain versions' times, the peak memory of one forward and backward, and
    the bounds for the steps this run's ants take. Emits one line."""
    import torch

    from deepaco_tpu_torch.ops import rollout

    dev = score.device
    b, n = score.shape[0], score.shape[-1]
    a, t = start.shape[1], noise.shape[0]
    grads = lambda d: d if isinstance(d, tuple) else (d,)   # the blend: also heu_pow's, phe's
    g = torch.randn((b, t, a), generator=torch.Generator(device=dev).manual_seed(SEED + 30),
                    device=dev)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    paths_k, logp_k, trace = rollout.fused_rollout_forward(score, start, noise, shape)
    d_k = grads(rollout.fused_rollout_backward(score, trace, g, shape))
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    again = grads(rollout.fused_rollout_backward(score, trace, g, shape))
    leaves, leaf_shape = (score.clone().requires_grad_(True),), shape
    if shape.kind == "blend":
        # heu ** beta given as the heuristic with beta 1 (a copy, whose
        # gradient passes unchanged), so that autograd's gradient in it is
        # the entry's d_heu_pow
        heu_pow = (shape.heu.detach() ** shape.beta).requires_grad_(True)
        phe = shape.phe.detach().clone().requires_grad_(True)
        leaves, leaf_shape = leaves + (heu_pow, phe), shape._replace(heu=heu_pow, beta=1.0,
                                                                      phe=phe)
    _, logp_a = rollout.fused_rollout(leaves[0], start, noise, leaf_shape)
    d_a = torch.autograd.grad(logp_a, leaves, g)
    with torch.no_grad():
        paths_p, logp_p = rollout.fused_rollout_plain(score, start, noise, shape)
    d_p = grads(rollout.rollout_backward_plain(score, paths_p, g, shape))
    scales = [x.abs().max().item() for x in d_p]
    scale = max(scales)
    paths_equal = bool(torch.equal(paths_k, paths_p))
    logp_ok = bool(torch.allclose(logp_k, logp_p, rtol=1e-5, atol=1e-6))
    d_ok = all(bool(torch.allclose(k, p, rtol=1e-4, atol=1e-5 * s))
               for k, p, s in zip(d_k, d_p, scales))
    repeat_equal = all(bool(torch.equal(k, r) and torch.equal(k, u))
                       for k, r, u in zip(d_k, again, d_a))
    fwd_ms = cuda_ms(lambda: rollout.fused_rollout_forward(score, start, noise, shape), 5)
    bwd_ms = cuda_ms(lambda: rollout.fused_rollout_backward(score, trace, g, shape), 5)
    with torch.no_grad():
        plain_ms = cuda_ms(lambda: rollout.fused_rollout_plain(score, start, noise, shape), 1)
    bwd_plain_ms = cuda_ms(lambda: rollout.rollout_backward_plain(score, paths_p, g, shape), 1)
    # the backward's kernels: ITEMS' and the blend's two passes are summed
    bwd_names = {"items": ("rollout_bwd", "rollout_items_sum"),
                 "blend": ("rollout_bwd_blend_terms", "rollout_bwd_blend_rows")}.get(
                     shape.kind, ("rollout_bwd",))
    device = kernel_device_ms(lambda: (rollout.fused_rollout_forward(score, start, noise, shape),
                                       rollout.fused_rollout_backward(score, trace, g, shape)),
                              ("rollout_fwd",) + bwd_names)
    parts = [device.pop(k) for k in bwd_names]
    device["rollout_bwd"] = "not measured" if "not measured" in parts else sum(parts)
    fwd_work, bwd_work, steps = rollout_work(score, noise, shape, paths_k)
    fwd_bound, bwd_bound = bound(*fwd_work), bound(*bwd_work)
    common = {"B": b, "N": n, "A": a, "T": t, "ant_steps": steps}
    out = {
        "config": config, **common, "passed": paths_equal and logp_ok and d_ok and repeat_equal,
        "paths_equal": paths_equal, "logp_close": logp_ok, "d_score_close": d_ok,
        "d_score_repeat_and_autograd_equal": repeat_equal, "peak_gb": peak_gb,
        "forward": {"max_abs_err": (logp_k - logp_p).abs().max().item(), "ms": fwd_ms,
                    "device_ms": device["rollout_fwd"], "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
        "backward": {"max_abs_err": max((k - p).abs().max().item() for k, p in zip(d_k, d_p)),
                     "d_score_scale": scale,
                     "ms": bwd_ms, "device_ms": device["rollout_bwd"], "plain_ms": bwd_plain_ms,
                     "library_ms": None, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]}}
    emit({"phase": "kernel", "name": "fused_rollout", **out, "tolerance": ROLLOUT_TOLERANCE})
    return out


def check_rollout_paths(cuda_ms, score, start, noise, shape, config: str) -> dict:
    """K7r's untraced forward (``fused_rollout_paths``, the inference route)
    on a rollout's own inputs: its paths against ``fused_rollout_paths_plain``
    on the same noise and against the traced forward's, bit for bit; its
    time by CUDA events and by the profiler's device time, the traced
    forward's and the plain version's beside it, the peak memory of one
    call, and the bound of the steps this run's ants take. Emits one line."""
    import torch

    from deepaco_tpu_torch.ops import rollout

    b, n = score.shape[0], score.shape[-1]
    a, t = start.shape[1], noise.shape[0]
    untraced = lambda: rollout.fused_rollout_forward(score, start, noise, shape, trace=False)[0]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    paths_k = untraced()
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    traced = rollout.fused_rollout_forward(score, start, noise, shape)[0]
    paths_p = rollout.fused_rollout_paths_plain(score, start, noise, shape)
    paths_equal = bool(torch.equal(paths_k, paths_p))
    traced_equal = bool(torch.equal(paths_k, traced))
    ms = cuda_ms(untraced, 5)
    traced_ms = cuda_ms(lambda: rollout.fused_rollout_forward(score, start, noise, shape), 5)
    plain_ms = cuda_ms(lambda: rollout.fused_rollout_paths_plain(score, start, noise, shape), 1)
    device = kernel_device_ms(untraced, ("rollout_fwd",))
    work, _, steps = rollout_work(score, noise, shape, paths_k, traced=False)
    bound_ms, bound_by = bound(*work)
    out = {"config": config, "B": b, "N": n, "A": a, "T": t, "ant_steps": steps,
           "passed": paths_equal and traced_equal, "paths_equal_plain": paths_equal,
           "paths_equal_traced": traced_equal, "peak_gb": peak_gb,
           "noise_gb": noise.numel() * 4 / 1e9,
           "max_abs_err": float((paths_k - paths_p).abs().max()),
           "ms": ms, "device_ms": device["rollout_fwd"], "traced_ms": traced_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
           "bound_by": bound_by, "chain_ms_at_2_4_us_a_step": t * 2.4e-3}
    emit({"phase": "kernel", "name": "fused_rollout_paths", **out,
          "tolerance": "paths exact against the plain step loop and the traced forward"})
    return out


def rollout_entries(r: dict) -> dict:
    """``check_rollout``'s result as the fields of K7r's two entries in the
    kernels' line: name -> its shapes, error, times and bound."""
    shapes = {k: r[k] for k in ("config", "B", "N", "A", "T", "ant_steps")}
    return {"fused_rollout": {**shapes, **r["forward"]},
            "fused_rollout_backward": {**shapes, **r["backward"]}}


def check_cvrp_construct(dev, cuda_ms, score, demand, capacity: float,
                         config: str = "cvrp500, 1/d") -> dict:
    """K7c (``cvrp_construct``) against its plain version on ``score [B, N,
    N]`` and ``demand [B, N]`` at ``capacity`` (the CVRP path's shape, B=100,
    N=501, capacity 50, on ``1/d``; BPP120's, N=121, capacity 150, on its
    neural heuristic): paths bit-equal from equal generator states,
    stochastic and greedy, and valid (each customer or item once, no trip or
    bin above capacity); its time, the plain version's and the bound for
    the steps this run's ants take."""
    import torch

    from deepaco_tpu_torch.aco.problems.cvrp import validate_routes
    from deepaco_tpu_torch.ops import cvrp_construct as cc

    gen = lambda: torch.Generator(device=dev).manual_seed(SEED + 9)
    modes = {}
    for stochastic in (True, False):
        got = cc.cvrp_construct(score, demand, capacity, A, gen(), stochastic=stochastic)
        want = cc.cvrp_construct_plain(score, demand, capacity, A, gen(),
                                       stochastic=stochastic)
        modes["stochastic" if stochastic else "greedy"] = {
            "equal": bool(torch.equal(got, want)),
            "valid": bool(validate_routes(got, demand, capacity).all()),
            "differing_entries": int((got != want).sum()),
            "max_abs_err": (got - want).abs().max().item()}
        if stochastic:
            paths = got
    b, rows, a = paths.shape
    n = score.shape[-1]
    # the steps each ant takes before it is back at the depot for good
    served = (paths != 0).long() * torch.arange(rows, device=dev)[None, :, None]
    steps = int((served.amax(dim=1) + 1).sum())
    g = gen()
    ms = cuda_ms(lambda: cc.cvrp_construct(score, demand, capacity, A, g), 10)
    plain_ms = cuda_ms(lambda: cc.cvrp_construct_plain(score, demand, capacity, A, g), 1)
    ok = all(m["equal"] and m["valid"] for m in modes.values())
    # score read once, demand read once, paths written once; per entry of
    # the steps taken: the uniform's add and multiply, two logarithms, the
    # noise add, the capacity compare, the mask select and the running-max
    # compare
    nbytes = 4 * b * n * n + 4 * b * n + 8 * b * rows * a
    emit({"phase": "kernel", "name": "cvrp_construct", "config": config, "B": b, "N": n,
          "A": a, "capacity": capacity, "passed": ok, **modes, "steps_taken": steps,
          "steps_bound": b * a * (rows - 1), "ms": ms, "plain_ms": plain_ms,
          "tolerance": "paths bit-equal to the plain version (the same Philox noise)"})
    return {"name": "cvrp_construct", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/cvrp_sweep.cu",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:65 (the CVRP construction scan, "
                        "deepaco_tpu/aco/engine.py:104-129)",
            "max_abs_err": max(m["max_abs_err"] for m in modes.values()),
            "ms": ms, "plain_ms": plain_ms, "library_ms": None, "passed": ok,
            **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 8 * steps * n)))}


def deposit_case(dev, cuda_ms, p, w, n: int, cyclic: bool) -> dict:
    """K8 on ``paths [B, L, A]`` and ``amounts [B, A]`` over ``n`` nodes:
    equal bits to ``scatter_add_`` on the CPU and on a second launch, within
    the rounding of two sums in other orders of ``scatter_add_`` on the card;
    its time and ``torch.scatter_add``'s, timed in turns."""
    import torch

    from deepaco_tpu_torch.ops import deposit

    b, l, a = p.shape
    got = deposit.tour_deposit(p, w, n, cyclic=cyclic)
    again = deposit.tour_deposit(p, w, n, cyclic=cyclic)
    plain = deposit.tour_deposit_plain(p, w, n, cyclic=cyclic)
    cpu = deposit.tour_deposit_plain(p.cpu(), w.cpu(), n, cyclic=cyclic)
    u, v = deposit.tour_edges(p, cyclic)
    index, values = (u * n + v).flatten(-2), w[..., None].expand(u.shape).flatten(-2)
    zeros = torch.zeros((b, n * n), device=dev)
    edges = index.shape[-1]
    # k, the terms of each entry: two sums of k positive terms in other
    # orders differ by at most 2 k 2^-24 of their value
    k = deposit.tour_deposit_plain(p, torch.ones_like(w), n, cyclic=cyclic)
    # K8 and scatter_add take a tenth of a millisecond, so a stall of the
    # host between launches shows in a mean: both are timed the same way,
    # in turns, and each reports the median of 5 means of 20 launches
    means = {"ms": [], "library_ms": []}
    for _ in range(5):
        means["ms"].append(cuda_ms(lambda: deposit.tour_deposit(p, w, n, cyclic=cyclic), 20))
        means["library_ms"].append(
            cuda_ms(lambda: torch.scatter_add(zeros, -1, index, values), 20))
    out = {
        "B": b, "L": l, "A": a, "n": n, "cyclic": cyclic,
        "self_loops_per_instance": ((u == v).sum() / b).item(),
        "max_terms_an_entry": k.max().item(),
        "equal_to_cpu_scatter": torch.equal(got.cpu(), cpu),
        "deterministic": torch.equal(got, again),
        "close_to_card_scatter": bool(((got - plain).abs() <= 2 * k * 2.0 ** -24 * got).all()),
        "max_rel_err_card_scatter": ((got - plain).abs() / got.clamp_min(1e-30)).max().item(),
        "max_abs_err": (got - plain).abs().max().item(),
        "ms": statistics.median(means["ms"]),
        "plain_ms": cuda_ms(lambda: deposit.tour_deposit_plain(p, w, n, cyclic=cyclic), 5),
        "library_ms": statistics.median(means["library_ms"]),
        "means_ms": means,
        # paths (int64) and amounts read once, D written once; one add an edge
        **dict(zip(("bound_ms", "bound_by"), bound(
            8 * b * l * a + 4 * b * a + 4 * b * n * n, b * edges)))}
    out["passed"] = all(out[key] for key in (
        "equal_to_cpu_scatter", "deterministic", "close_to_card_scatter"))
    return out


def check_deposit(dev, cuda_ms, tsp_paths, tsp_amounts, cvrp_paths, cvrp_amounts) -> dict:
    """K8 against ``scatter_add_`` at the CVRP path's shape (routes sampled by
    K7 on ``1/d``) and at the main path's (K2's tours); returns K8's entry of
    the kernels' line and emits one line."""
    cases = {"cvrp": (cvrp_paths, cvrp_amounts, CVRP_N + 1, False),
             "tsp": (tsp_paths, tsp_amounts, N, True)}
    out = {name: deposit_case(dev, cuda_ms, *case) for name, case in cases.items()}
    emit({"phase": "kernel", "name": "tour_deposit", **out,
          "tolerance": "equal bits to scatter_add_ on the CPU (ant-major, one add at a "
                       "time) and on a second launch; to scatter_add_ on the card (atomics "
                       "in any order) within 2 k 2^-24 of each entry, k its terms"})
    c = out["cvrp"]
    return {"name": "tour_deposit", "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/tour_deposit.cu",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:340",
            "max_abs_err": max(r["max_abs_err"] for r in out.values()),
            "passed": all(r["passed"] for r in out.values()),
            "tsp_ms": out["tsp"]["ms"], "tsp_library_ms": out["tsp"]["library_ms"],
            "below_library": all(r["ms"] < r["library_ms"] for r in out.values()),
            **{k: c[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}}


def check_layer(dev, cuda_ms, net, g, backward: bool = False) -> dict:
    """K6's forward on a path's graph ``g`` (CVRP's dense one at N = K =
    501, OP's k-NN one, ...; U=32) on the first layer's real inputs, against
    its plain version; with ``backward`` also K6's backward on random
    cotangents (``"backward"``)."""
    import torch
    from torch.nn import functional as F

    from deepaco_tpu_torch.ops import gnn_layer

    emb = net.emb_net
    b, n, k = g.nbr.shape
    u = emb.units
    with torch.no_grad():
        x = F.silu(emb.v_lin0(g.x))
        w = F.silu(emb.e_lin0(g.edge))
        index = gnn_layer.reverse_adjacency(g.nbr)
        lin = emb.e_lins0[0]
        args = (emb.v_lins2[0](x), emb.v_lins3[0](x), emb.v_lins4[0](x), g.nbr, w,
                lin.weight.T, lin.bias, index)
        got = gnn_layer.fused_gnn_layer(*args)
        want = gnn_layer.fused_gnn_layer_plain(*args)
        ok = all(bool(torch.allclose(a, r, rtol=1e-5, atol=1e-5)) for a, r in zip(got, want))
        err = max((a - r).abs().max().item() for a, r in zip(got, want))
        del got, want
        ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer(*args), 5)
        plain_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 2)
    out = {"B": b, "N": n, "K": k, "passed": ok, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, **dict(zip(("bound_ms", "bound_by"), bound(
               *k6_forward_work(b, n, n, k, u))))}
    if backward:
        x2, ew = args[0], args[5]
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        ca = torch.randn((b, n, u), generator=gen, device=dev)
        cp = torch.randn((b, n, k, u), generator=gen, device=dev)
        b_k = gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp)
        b_p = gnn_layer.fused_gnn_layer_backward_plain(x2, g.nbr, w, ew, ca, cp)
        names = ("x2", "x3", "x4", "w", "ew", "eb")
        out["backward"] = {
            "passed": all(bool(torch.allclose(a, r, rtol=1e-4, atol=1e-5 * r.abs().max().item()))
                          for a, r in zip(b_k, b_p)),
            "max_abs_err": max((a - r).abs().max().item() for a, r in zip(b_k, b_p)),
            "norm_err": {nm: norm_err(a, r) for nm, a, r in zip(names, b_k, b_p)},
            "ms": cuda_ms(lambda: gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp), 5),
            "plain_ms": cuda_ms(lambda: gnn_layer.fused_gnn_layer_backward_plain(
                x2, g.nbr, w, ew, ca, cp), 2),
            **dict(zip(("bound_ms", "bound_by"), bound(*k6_backward_work(b, n, k, u))))}
    return out


def ls_bound(n: int, b: int, a: int, scans: dict, metric_bytes: int):
    """K4/K5's least time for the scans the plain version counted: each scan
    evaluates (n-1)(n-2)/2 pairs at 3 add/sub and a compare, the pair's two
    entries read from a matrix: the bf16 metric, or the instance's f32
    distance matrix, built once at B*n*n distances of 7 operations (2 sub,
    2 mul, 2 add, 1 sqrt). Bytes: the metric, the distance matrix, the
    coordinates, and the tours read and written at 4 bytes a city."""
    pairs = (n - 1) * (n - 2) / 2
    ops = 4 * pairs * (scans.get("true", 0) + scans.get("perturb", 0)) + 7 * b * n * n
    return bound(metric_bytes + 4 * b * n * n + 4 * b * n * 2 + 2 * 4 * b * a * n,
                 ops)


def train_configs():
    """The two training envelopes, at full width: name -> (config, Net
    arguments, local-search hook). TSP500: tsp/train.ipynb's envelope, which
    trained ``tsp500_selftrained`` (RESULTS.md:177); TSP500-NLS:
    ``scripts/train_tsp_nls500.py``'s (tsp_nls/train.py:138-141), which
    trained ``tsp_nls500_selftrained``."""
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig
    from deepaco_tpu_torch.train.reinforce import nls_local_search

    tsp = ProblemConfig(
        n_nodes=N, k_sparse=K, aco=ACOSettings(n_ants=A_TRAIN),
        train=TrainConfig(lr=3e-4, weight_decay=1e-2, grad_clip=3.0, epochs=5,
                          steps_per_epoch=128, batch_size=1,
                          cosine_schedule=False, seed=SEED))
    nls = ProblemConfig(
        name="tsp_nls", n_nodes=N, k_sparse=K, aco=ACOSettings(n_ants=A_TRAIN_NLS),
        train=TrainConfig(lr=6e-4, weight_decay=1e-2, grad_clip=3.0, epochs=20,
                          steps_per_epoch=20, batch_size=B_TRAIN,
                          cosine_schedule=True, seed=SEED))
    return {"tsp500": (tsp, {"dual_heads": True}, None),
            "tsp500_nls": (nls, {"feats": 1}, nls_local_search())}


def norm_err(got, ref) -> float:
    """``max |got - ref|`` over ``max |ref|``."""
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def check_training_kernels(dev, cuda_ms, kernels: list) -> bool:
    """K6 (forward, backward), row 8 through K6 and K7 against their plain
    versions at the TSP-NLS training shapes; appends K6's and K7's entries
    to ``kernels``, emits one line each and returns whether row 8 passed."""
    import torch

    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.ops import gnn_layer, pick
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    b, u = B_TRAIN, gnn_layer.UNITS
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED + 4), batch=b, device=dev)
    dist = distance_matrix(coords)
    nbr = topk_smallest(dist, K)[1]
    index = gnn_layer.reverse_adjacency(nbr)
    x2, x3, x4, w = rnd(b, N, u), rnd(b, N, u), rnd(b, N, u), rnd(b, N, K, u)
    ew, eb = rnd(u, u) * 0.1, rnd(u) * 0.1
    args = (x2, x3, x4, nbr, w, ew, eb, index)

    with torch.no_grad():
        agg_k, pre_k = gnn_layer.fused_gnn_layer(*args)
        agg_p, pre_p = gnn_layer.fused_gnn_layer_plain(*args)
    fwd_err = max((agg_k - agg_p).abs().max().item(), (pre_k - pre_p).abs().max().item())
    fwd_ok = bool(torch.allclose(agg_k, agg_p, rtol=1e-5, atol=1e-5)
                  and torch.allclose(pre_k, pre_p, rtol=1e-5, atol=1e-5))

    # all six input gradients under the mixed loss of
    # tests/test_pallas_kernels.py:223-235, through autograd on both sides
    ca, cp = rnd(b, N, u), rnd(b, N, K, u)

    def grads(layer):
        leaves = [t.clone().requires_grad_(True) for t in (x2, x3, x4, w, ew, eb)]
        agg, pre = layer(leaves[0], leaves[1], leaves[2], nbr, leaves[3], leaves[4],
                         leaves[5], index)
        ((agg * ca).sum() + (torch.tanh(pre) * cp).sum()).backward()
        return [t.grad for t in leaves]

    names = ("x2", "x3", "x4", "w", "ew", "eb")
    g_k, g_p = grads(gnn_layer.fused_gnn_layer), grads(gnn_layer.fused_gnn_layer_plain)
    grad_errs = {n: norm_err(a, r) for n, a, r in zip(names, g_k, g_p)}
    # the backward entry itself on identical cotangents
    b_k = gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp)
    b_p = gnn_layer.fused_gnn_layer_backward_plain(x2, nbr, w, ew, ca, cp)
    order = ("x2", "x3", "x4", "w", "ew", "eb")
    entry_errs = {n: norm_err(a, r) for n, a, r in zip(order, b_k, b_p)}
    close = lambda a, r: bool(torch.allclose(a, r, rtol=1e-4,
                                             atol=1e-5 * r.abs().max().item()))
    bwd_ok = all(close(a, r) for a, r in zip(g_k, g_p)) and all(
        close(a, r) for a, r in zip(b_k, b_p))
    bwd_err = max((a - r).abs().max().item() for a, r in zip(b_k, b_p))

    agg_only = gnn_layer.gated_mean_aggregate(x2, nbr, w)
    row8_ok = bool(torch.allclose(agg_only, agg_p, rtol=1e-5, atol=1e-5))
    row8 = {"phase": "kernel", "name": "gated_mean_aggregate", "route": "cuda (K6, pre skipped)",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:114", "B": b, "N": N, "K": K,
            "passed": row8_ok, "max_abs_err": (agg_only - agg_p).abs().max().item(),
            "ms": cuda_ms(lambda: gnn_layer.gated_mean_aggregate(x2, nbr, w), 20),
            "plain_ms": cuda_ms(lambda: gnn_layer.gated_mean_aggregate_plain(x2, nbr, w), 5),
            "tolerance": "rtol 1e-5, atol 1e-5 (sum order of the mean)"}
    row8.update(zip(("bound_ms", "bound_by"), bound(*k6_forward_work(b, N, N, K, u, False))))
    emit(row8)

    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer(*args), 20)
        fwd_plain_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 5)
    bwd_ms = cuda_ms(lambda: gnn_layer.fused_gnn_layer_backward(x2, index, w, ew, ca, cp), 20)
    bwd_plain_ms = cuda_ms(
        lambda: gnn_layer.fused_gnn_layer_backward_plain(x2, nbr, w, ew, ca, cp), 5)
    kernels.append({
        "name": "fused_gnn_layer", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:203",
        "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
        "library_ms": None, "passed": fwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k6_forward_work(b, N, N, K, u))))})
    kernels.append({
        "name": "fused_gnn_layer_backward", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/gnn_layer.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:275 (fused_gnn_layer_ad, _fused_ad_bwd 290)",
        "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
        "library_ms": None, "passed": bwd_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k6_backward_work(b, N, K, u))))})
    emit({"phase": "kernel", "name": "fused_gnn_layer", "B": b, "N": N, "K": K, "U": u,
          "forward_passed": fwd_ok, "backward_passed": bwd_ok,
          "forward_max_abs_err": fwd_err, "autograd_grad_err": grad_errs,
          "backward_entry_err": entry_errs,
          "tolerance": "forward rtol 1e-5, atol 1e-5 (sum order of 32-term products "
                       "and the K-term mean); gradients rtol 1e-4 (JAX's own test), "
                       "atol 1e-5 of the largest entry (d_x2, d_x4 and d_ew sum "
                       "hundreds to 500,000 terms, the plain scatter with atomics)"})

    # K7 on [600, 500] rows in the middle of a rollout: the score rows of the
    # instances' -log(distance), each with a random share of its columns visited
    rows = B_TRAIN * A_TRAIN_NLS
    score = torch.log(1.0 / dist).reshape(-1, N)[:rows].contiguous()
    visited_count = torch.randint(1, N, (rows, 1), generator=g, device=dev)
    rank = torch.argsort(torch.argsort(torch.rand((rows, N), generator=g, device=dev), dim=1), dim=1)
    mask = (rank >= visited_count).float()
    noise = gumbel((rows, N), g, dev)
    with torch.no_grad():
        act_k, logp_k = pick.fused_pick(score, mask, noise)
        act_p, logp_p = pick.fused_pick_plain(score, mask, noise)
    c = rnd(rows)

    def pick_grad(fn):
        sc = score.clone().requires_grad_(True)
        (fn(sc, mask, noise)[1] * c).sum().backward()
        return sc.grad

    d_k, d_p = pick_grad(pick.fused_pick), pick_grad(pick.fused_pick_plain)
    k7_err = (logp_k - logp_p).abs().max().item()
    k7_ok = bool(torch.equal(act_k, act_p)
                 and torch.allclose(logp_k, logp_p, rtol=1e-5, atol=1e-5)
                 and torch.allclose(d_k, d_p, rtol=1e-5, atol=1e-6)
                 and bool((mask.gather(1, act_k[:, None]) > 0).all()))
    with torch.no_grad():
        k7_ms = cuda_ms(lambda: pick.fused_pick(score, mask, noise), 50)
        k7_plain_ms = cuda_ms(lambda: pick.fused_pick_plain(score, mask, noise), 20)
    kernels.append({
        "name": "fused_pick", "route": "cuda", "source": "deepaco_tpu_torch/csrc/pick.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:65",
        "max_abs_err": k7_err, "ms": k7_ms, "plain_ms": k7_plain_ms,
        "library_ms": None, "passed": k7_ok,
        # three [R, N] f32 reads, action (8 bytes) and logp out; a select,
        # an add, a compare, a subtract, an exp and an add per entry
        **dict(zip(("bound_ms", "bound_by"), bound(3 * 4 * rows * N + 12 * rows,
                                                    6 * rows * N)))})
    emit({"phase": "kernel", "name": "fused_pick", "rows": rows, "N": N,
          "passed": k7_ok, "actions_equal": bool(torch.equal(act_k, act_p)),
          "logp_max_abs_err": k7_err, "d_rows_max_abs_err": (d_k - d_p).abs().max().item(),
          "open_per_row": [int(mask.sum(1).min()), int(mask.sum(1).max())],
          "tolerance": "actions exact; logp rtol 1e-5, atol 1e-5 and d_rows rtol 1e-5, "
                       "atol 1e-6 (logsumexp order, expf/logf against torch's)"})
    return row8_ok


def step_agreement(cfg, net_k, net_p, before: dict, out_k, out_p, advantage) -> dict:
    """One training step's kernel arm (``net_k``, ``out_k``: sampled through
    the kernels, backward taken) against its plain arm (``net_p``,
    ``out_p``: the same paths replayed with the plain layer, backward
    taken), both from the weights ``before``: loss, gradients, the AdamW
    update (applied here to both nets) and the running statistics.
    ``advantage [B, A]`` scales the loss's tolerance."""
    import torch

    from deepaco_tpu_torch.train import reinforce as tr

    arms = {}
    for arm, net in (("kernel", net_k), ("plain", net_p)):
        arms[arm] = {n: (p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p)) for n, p in net.named_parameters()}
    biggest = max(g.abs().max().item() for g in arms["plain"].values())
    # a leaf whose gradient is rounding noise (a bias that a BatchNorm
    # cancels: exact gradient 0) is held against 1e-2 of the largest gradient
    grad_errs = {n: ((arms["kernel"][n] - g).abs().max()
                     / max(g.abs().max().item(), 1e-2 * biggest)).item()
                 for n, g in arms["plain"].items()}
    scale = (advantage.abs() * out_k.log_probs.sum(dim=-2).abs()).sum(-1).mean().item() \
        / cfg.aco.n_ants
    loss_err = abs(out_k.loss.item() - out_p.loss.item())
    for net in (net_k, net_p):
        tr.optimizer_update(tr.TrainState(net, tr.make_optimizer(net, cfg), 0,
                                          cfg.train.cosine_schedule), cfg)
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    param_ok, param_err = True, 0.0
    for n, p in net_p.named_parameters():
        g = arms["plain"][n]
        got = dict(net_k.named_parameters())[n].detach()
        signal = g.abs() > 1e-4 * biggest
        if bool(signal.any()):
            param_err = max(param_err, (got - p)[signal].abs().max().item())
            param_ok &= bool(torch.allclose(got[signal], p.detach()[signal], rtol=1e-5, atol=1e-6))
        moved = (got - before[n]).abs()
        param_ok &= bool((moved <= lr * (1 + 1e-3) + lr * wd * before[n].abs()).all())
    stats = lambda net: {k: v for k, v in net.state_dict().items() if "running" in k}
    bn_err = max((norm_err(a, b) for a, b in zip(stats(net_k).values(),
                                                 stats(net_p).values())), default=0.0)
    ok = (loss_err <= 1e-5 * scale and max(grad_errs.values()) <= 1e-3 and param_ok
          and bn_err <= 1e-4 and bool(torch.isfinite(out_k.loss)))
    worst = max(grad_errs, key=grad_errs.get)
    return {"passed": ok, "loss_kernel": out_k.loss.item(), "loss_plain": out_p.loss.item(),
            "loss_abs_err": loss_err, "loss_term_scale": scale,
            "mean_cost": out_k.mean_cost.item(), "grad_max_norm_err": grad_errs[worst],
            "grad_worst_leaf": worst, "param_max_abs_err": param_err,
            "running_stats_norm_err": bn_err, "gradient_leaves": len(grad_errs),
            "tolerance": "loss within 1e-5 of sum |advantage * sum log p| / A; each "
                         "gradient within 1e-3 of its largest entry, or of 1e-2 of the "
                         "largest gradient where that is larger (the biases a BatchNorm "
                         "cancels have gradient 0 plus rounding noise); weights after "
                         "AdamW rtol 1e-5 / atol 1e-6 where |g| > 1e-4 of the largest "
                         "gradient (a first Adam step moves by lr * sign(g)), else moved "
                         "at most lr; running statistics within 1e-4"}


def train_step_arms(dev, name: str, rollouts: list | None = None) -> dict:
    """One training step of configuration ``name`` from the same weights and
    instances: the kernel arm samples through K6, K7r (and K5), the plain
    arm replays its paths with the plain layer. Returns the comparison; K7r's
    inputs go to ``rollouts``."""
    import copy

    import torch

    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.datasets import uniform_coords

    cfg, net_kwargs, ls = train_configs()[name]
    net_k = init_like_flax(Net(**net_kwargs).to(dev),
                           torch.Generator(device=dev).manual_seed(SEED))
    net_p = copy.deepcopy(net_k)
    before = copy.deepcopy(net_k.state_dict())
    coords = uniform_coords(N, torch.Generator().manual_seed(SEED + 2),
                            batch=cfg.train.batch_size, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    with captured_rollouts([] if rollouts is None else rollouts):
        out_k = tr.tsp_loss(net_k, coords, cfg, gen, local_search=ls)
    out_k.loss.backward()
    replay_ls = (lambda *a: out_k.ls_costs) if ls is not None else None
    out_p = tr.tsp_loss(net_p, coords, cfg, gen, local_search=replay_ls,
                        paths=out_k.paths, _ops=tr.PLAIN_OPS)
    out_p.loss.backward()
    advantage = out_k.costs - out_k.costs.mean(dim=-1, keepdim=True)
    if out_k.ls_costs is not None:
        ls_dev = out_k.ls_costs - out_k.ls_costs.mean(dim=-1, keepdim=True)
        advantage = 0.95 * ls_dev + 0.05 * advantage
    return {"phase": "train_step", "config": name,
            "B": cfg.train.batch_size, "N": N, "K": K, "A": cfg.aco.n_ants,
            **step_agreement(cfg, net_k, net_p, before, out_k, out_p, advantage)}


def family_train_config(name: str = "cvrp"):
    """A family's training at the envelope that trained its largest
    checkpoint (RESULTS.md:175-181): batch 1, lr 3e-4, AdamW with weight
    decay 1e-2, clip 3.0, the family's 12-layer 32-unit Net. CVRP500
    (cvrp/train.ipynb): 500 customers (demands 1-9, capacity 50), 50 ants,
    5 x 128 steps, the dense graph with self-loops, K = N = 501. OP300: 20
    ants, 15 x 64 steps, the k-NN graph, K = 30. PCTSP500: 20 ants, 15 x 128
    steps, the dense graph, K = N = 501. SMTWTP500: 50 ants, 5 x 128 steps,
    the dense job graph, K = N = 501, no node update. SOP100: 50 ants, 5 x
    128 steps, the masked dense graph, K = N = 100, no node update. BPP120:
    120 ants, 5 x 64 steps, the dense graph, K = N = 121, capacity 150.
    MKP300: 50 ants, 10 x 64 steps, the dense graph with five node
    features, K = N = 300, weight decay 0 (mkp/train.py:78)."""
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig

    n, _, ants, epochs, steps = FAMILY_PATHS[name]
    return ProblemConfig(
        name=name, n_nodes=n, k_sparse=max(n // 10, 3),
        aco=ACOSettings(n_ants=ants),
        train=TrainConfig(lr=3e-4, weight_decay=0.0 if name == "mkp" else 1e-2,
                          grad_clip=3.0, epochs=epochs,
                          steps_per_epoch=steps, batch_size=1, cosine_schedule=False,
                          seed=SEED))


def family_train_inputs(dev, name: str = "cvrp"):
    """Where ``train_family(name, family_train_config(name))`` starts: the
    family, the configuration, the state initialised from the seed (one
    instance drawn for the template graph, as ``init_family_state`` does),
    and the numpy stream and generator that the steps go on drawing from."""
    import numpy as np
    import torch

    from deepaco_tpu_torch.families import get_family
    from deepaco_tpu_torch.train import drivers

    family, cfg = get_family(name), family_train_config(name)
    rng = np.random.default_rng(cfg.train.seed)
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    return family, cfg, drivers.init_family_state(family, cfg, rng, gen), rng, gen


def family_train_step_arms(dev, name: str = "cvrp"):
    """One training step of a family from the seed's weights on the first
    batch that ``train_family`` draws: the kernel arm samples through K6 (a
    GNN's) and K7r, the plain arm replays its paths with the plain layer.
    Returns the comparison (with the solutions' validity and costs), K7r's
    inputs ``[(score, start, noise, shape)]``, the batch and the stepped
    net."""
    import copy

    import torch

    from deepaco_tpu_torch.train import drivers

    family, cfg, state, rng, gen = family_train_inputs(dev, name)
    net_k = state.net
    net_p = copy.deepcopy(net_k)
    before = copy.deepcopy(net_k.state_dict())
    batch = drivers.gen_batch(family, rng, cfg.n_nodes, cfg.train.batch_size)
    inst = family.prepare(drivers.instance_tensors(batch, dev))
    captured = []
    with captured_rollouts(captured):
        out_k = drivers.family_loss(family, net_k, inst, cfg, gen)
    out_k.loss.backward()
    out_p = drivers.family_loss(family, net_p, inst, cfg, gen, paths=out_k.paths,
                                _ops=drivers.PLAIN_OPS)
    out_p.loss.backward()
    valid = valid_solutions(name, out_k.paths, inst)
    costs_match = bool(torch.equal(family.cost(out_k.paths, inst), out_k.costs))
    check = step_agreement(cfg, net_k, net_p, before, out_k, out_p,
                           out_k.costs - out_k.costs.mean(dim=-1, keepdim=True))
    check.update(valid_routes=int(valid.sum()), routes=valid.numel(),
                 route_costs_match=costs_match,
                 passed=check["passed"] and bool(valid.all()) and costs_match)
    n_states = family.horizon_states(cfg.n_nodes)[0]
    return ({"B": cfg.train.batch_size, "N": n_states, "A": cfg.aco.n_ants, **check},
            captured, batch, net_k)


def family_rollout(dev, name: str, net, ds):
    """One construction of a phase-14 family's path at its full size (the
    golden set, A=20) on its neural heuristic with tau = 1: for BPP one K7c
    launch (``cvrp_construct`` on the score matrix, as its first iteration
    runs it), for the others (OP, PCTSP, SMTWTP, SOP, MKP, MKP-items) one
    launch of K7r's untraced forward. Returns the paths, the update's
    amounts (``q * objective`` for OP, MKP and MKP-items, ``fitness / A``
    for BPP, ``1 / (cost + offset)`` else), the graph, K7r's ``[(score,
    start, noise, shape)]`` (none for BPP), and the score matrix (MKP-items:
    its one row an instance)."""
    import torch

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import BPP_CAPACITY, get_family
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.train import drivers

    fam = get_family(name)
    inst = fam.prepare(drivers.instance_tensors(ds, dev))
    n = FAMILY_PATHS[name][0]
    with torch.no_grad():
        heu = drivers._forward_heu(fam, net.eval(), inst, fam.k_sparse(n))
        score = score_matrix(torch.ones_like(heu), heu, 1.0, 1.0)
    graph = fam.graph(inst, fam.k_sparse(n)) if fam.model_ctor is None else None
    if name in ONE_PASS:
        with torch.no_grad():
            paths = cc.cvrp_construct(score, inst["demand"], BPP_CAPACITY, A,
                                      torch.Generator(device=dev).manual_seed(SEED + 12))
        return paths, fam.cost(paths, inst) / A, graph, [], score
    spec = fam.spec(torch.ones_like(heu), heu, inst, A)
    captured = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    with torch.no_grad(), captured_rollouts(captured):
        paths = rollout(spec, gen).paths
        costs = fam.cost(paths, inst)
    q = fam.extras(inst).get("q")
    amounts = q[:, None] * costs if fam.aco.maximize else 1.0 / (costs + fam.aco.cost_offset)
    return paths, amounts, graph, captured, score


def family_phase(dev, root: Path, cuda_ms, timer_cls, counted, name: str) -> dict:
    """Phase 14 for one family (OP300, PCTSP500, SMTWTP500, SOP100, BPP120,
    MKP300), and phase 16 for MKP-items 500: its kernels against their plain
    versions at its shapes (K7c for BPP, K7r's untraced forward for the
    others, K7r on its training rollout, K6, K8 and K9 where they run), its
    path in three arms, its training at the envelope, and the CLI's
    ``test``. Emits one line for the path and one
    for training, and returns what the kernels' line and the checks read.
    A family whose model is no GNN (MKP-items' transformer) has no K9 or K6
    to check or launch, and one whose pheromone is a vector no K8; where no
    K9 runs, the plain arm computes the kernel arm's heuristic and draws its
    noise, so their costs are held equal to the digit."""
    import io

    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.families import BPP_CAPACITY, get_family
    from deepaco_tpu_torch.models.gnn import jax_layout
    from deepaco_tpu_torch.ops import deposit, fused_gnn, gnn_layer, pick, rollout
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.train import drivers

    fam = get_family(name)
    n, ckpt = FAMILY_PATHS[name][:2]
    n_states = fam.horizon_states(n)[0]
    sign = -1.0 if fam.aco.maximize else 1.0
    gnn, edges = fam.model_ctor is None, not fam.aco.vector_pheromone
    net, ds = family_inputs(root, dev, name)
    inst = fam.prepare(drivers.instance_tensors(ds, dev))
    b = next(iter(inst.values())).shape[0]
    out = {"checks": {}}

    # kernels at the family's shapes: K9 on its graph (SOP's masked: no node
    # update, so the mask changes nothing before the heuristic applies it),
    # for BPP K7c on its score, for the others K7r's untraced forward on its
    # rollout, K8 on its routes (PCTSP's and BPP's park on node 0, the
    # self-loop repeated; MKP's on the dummy item)
    paths, amounts, g, picks, score = family_rollout(dev, name, net, ds)
    if gnn:
        out["k9"] = check_embnet_layers(cuda_ms, net, g, f"{name}{n}, K = {g.nbr.shape[-1]}"
                                        + (", masked" if g.mask is not None else ""))
        out["checks"]["k9"] = out["k9"]["passed"]
    if name in ONE_PASS:
        out["k7c"] = check_cvrp_construct(dev, cuda_ms, score, inst["demand"],
                                          BPP_CAPACITY, f"{name}{n}, neural heuristic")
        out["checks"]["k7c"] = out["k7c"]["passed"]
    else:
        out["k7r_paths"] = check_rollout_paths(cuda_ms, *picks[0],
                                               f"{name}{n} inference rollout, B={b}, A={A}")
        out["checks"]["k7r_paths"] = out["k7r_paths"]["passed"]
    if edges:
        out["k8"] = deposit_case(dev, cuda_ms, paths, amounts, n_states, False)
        out["k8"]["below_library"] = out["k8"]["ms"] < out["k8"]["library_ms"]
        emit({"phase": "kernel", "name": "tour_deposit", "config": f"{name}{n} routes",
              **out["k8"], "tolerance": "as phase 9"})
        out["checks"]["k8"] = out["k8"]["passed"]
    del paths, amounts, g, picks, score

    # the path in three arms, each with the counts set to 0 just before it
    # and read just after
    def arm(net_arg, ops):
        timer = timer_cls()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cost, curves, state = drive_family(net_arg, ds, ops._replace(timer=timer), name)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = state.best_path[..., None]
        valid = valid_solutions(name, best, inst)[:, 0]
        recost = fam.cost(best, inst)[:, 0]
        return {"cost": cost.tolist(), "wall_s": wall, "phase_ms": timer.ms(),
                "launches": {fn.__name__: fn.launches for fn in (
                    fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                    deposit.tour_deposit, cc.cvrp_construct, rollout.fused_rollout_paths)},
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "finite": bool(torch.isfinite(curves).all())
                and curves.shape == (b, max(T_VALUES)),
                "monotone": bool((sign * curves[:, 1:] <= sign * curves[:, :-1]).all()),
                "valid_best": int(valid.sum()),
                "best_cost_is_cost": bool(torch.allclose(recost, state.best_cost, rtol=1e-5))}

    arms = {"kernel": arm(net, drivers.KERNEL_OPS), "plain": arm(net, drivers.PLAIN_OPS),
            "classic": arm(None, drivers.KERNEL_OPS)}
    t_max = max(T_VALUES)
    # an iteration: one K7c launch (BPP) or one K7r launch
    passes_run = t_max if name in ONE_PASS else 0
    deposits = t_max if edges else 0
    construct = {"fused_pick": 0, "cvrp_construct": passes_run,
                 "fused_rollout_paths": t_max - passes_run}
    want = {"kernel": {"embnet_layers": int(gnn), "fused_gnn_layer": 0,
                       "tour_deposit": deposits, **construct},
            "plain": {"embnet_layers": 0, "fused_gnn_layer": 0, "fused_pick": 0,
                      "tour_deposit": 0, "cvrp_construct": 0, "fused_rollout_paths": 0},
            "classic": {"embnet_layers": 0, "fused_gnn_layer": 0, "tour_deposit": deposits,
                        **construct}}
    ck, cp, cc_ = (arms[a]["cost"] for a in ("kernel", "plain", "classic"))
    # JAX's costs are one run of its own stream, and one seed of the port
    # spreads by up to 5% about its mean (SMTWTP500, on the one-launch and
    # the per-step route alike: scripts/route_seed_spread.py), so the
    # anchor holds the kernel arm's mean over JAX_SEEDS seeds (seed 0 the
    # arm above)
    seed_costs = [ck] + [drive_family(net, ds, name=name, seed=seed)[0].tolist()
                         for seed in range(SEED + 1, SEED + JAX_SEEDS)]
    seed_mean = [statistics.fmean(c) for c in zip(*seed_costs)]
    if not gnn:
        out["checks"]["plain_equals_kernel"] = ([round(c, 4) for c in ck]
                                                == [round(c, 4) for c in cp])
    out["checks"].update(
        arms=all(r["finite"] and r["monotone"] and r["valid_best"] == b
                 and r["best_cost_is_cost"] for r in arms.values()),
        launches=all(arms[a]["launches"] == want[a] for a in arms),
        # the arms draw the same noise: at T1 only K9's rounding parts them
        t1_kernel_vs_plain=abs(ck[0] - cp[0]) <= 1e-4 * abs(cp[0]),
        t10_kernel_vs_plain=abs(ck[-1] - cp[-1]) <= 0.01 * abs(cp[-1]),
        neural_beats_classic=sign * ck[-1] < sign * cc_[-1],
        near_jax=all(abs(c - j) <= JAX_COST_SPAN * abs(j)
                     for c, j in zip(seed_mean, JAX_COSTS[name])))
    emit({"phase": f"{name}_path", "B": b, "N": n_states, "A": A, "T": list(T_VALUES),
          "ckpt": ckpt, "jax_costs": JAX_COSTS[name], "kernel_seed_costs": seed_costs,
          "kernel_seed_mean": seed_mean, "launches_expected": want, **arms})
    out["arms"] = arms

    # training at the envelope: (a) one step, kernel arm against plain arm
    step_check, train_picks, train_batch, train_net = family_train_step_arms(dev, name)
    tinst = fam.prepare(drivers.instance_tensors(train_batch, dev))
    layer = (check_layer(dev, cuda_ms, train_net, fam.graph(tinst, fam.k_sparse(n)),
                         backward=True) if gnn else None)
    rollout_train = check_rollout(cuda_ms, *train_picks[0], f"{name}{n} training rollout")
    del train_net, train_picks
    # (b) two steps of make_family_train_step, the counts set to 0 just
    # before each and read just after
    _, cfg, state, rng, gen = family_train_inputs(dev, name)
    timer = timer_cls()
    step_fn = drivers.make_family_train_step(fam, cfg, _ops=drivers.KERNEL_OPS._replace(
        timer=timer))
    start = {k: v.clone() for k, v in jax_layout(state.net.state_dict(), state.net).items()}
    # the weights that get a gradient: without weight decay (MKP) no other moves
    touched = set()
    for pname, p in state.net.named_parameters():
        p.register_hook(lambda g, pname=pname: touched.add(pname) if bool(g.any()) else None)
    rows = []
    for i in range(FAMILY_TRAIN_STEPS):
        batch = drivers.gen_batch(fam, rng, cfg.n_nodes, 1)
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, info = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        rows.append({"step": i, "loss": info.loss.item(), "mean_cost": info.mean_cost.item(),
                     "grad_norm": info.grad_norm.item(),
                     "wall_ms": (time.perf_counter() - t0) * 1e3, "phase_ms": timer.take(),
                     "launches": {fn.__name__: fn.launches for fn in counted}})
    depth = state.net.depth if gnn else 0
    want_step = {"fused_gnn_layer": depth, "fused_gnn_layer_backward": depth,
                 "fused_pick": 0, "fused_rollout": 1, "fused_rollout_backward": 1,
                 "fused_rollout_paths": 0, "cvrp_construct": 0, "embnet_layers": 0,
                 "tour_deposit": 0}
    moved = all(not torch.equal(start[k], v)
                for k, v in jax_layout(state.net.state_dict(), state.net).items()
                if (v.dim() == 2 and (k in touched or cfg.train.weight_decay > 0))
                or "running" in k)
    del state, start
    # (c) the CLI's test on the card: the kernel arm, through the CLI
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        cli_means, _ = cli.main(["test", name, "-n", str(n), "-c", str(root / ckpt),
                                 "-a", str(A), "--seed", str(SEED), "-t", *map(str, T_VALUES)])
    cli_lines = text.getvalue().splitlines()
    out["cli_costs"] = [float(v) for v in cli_means]
    out["train_launches"] = {fn.__name__: sum(r["launches"][fn.__name__] for r in rows)
                             for fn in counted}
    out["layer"] = layer
    out["rollout_train"] = rollout_train
    if gnn:
        out["checks"].update(k6_forward=layer["passed"], k6_backward=layer["backward"]["passed"])
    out["checks"].update(
        step_agreement=step_check["passed"],
        k7r_train=rollout_train["passed"],
        step_launches=all({k: r["launches"][k] for k in want_step} == want_step
                          for r in rows),
        train_finite=all(math.isfinite(r[key]) for r in rows
                         for key in ("loss", "mean_cost", "grad_norm")),
        weights_moved=moved,
        cli_lines=cli_lines[1:-1] == [f"T={t}, average cost is {v:.6f}."
                                      for t, v in zip(T_VALUES, cli_means)],
        cli_is_kernel_arm=[round(v, 4) for v in out["cli_costs"]]
        == [round(v, 4) for v in ck])
    emit({"phase": f"{name}_train", "B": 1, "N": n_states, "A": cfg.aco.n_ants,
          "lr": cfg.train.lr, "epochs_x_steps": [cfg.train.epochs, cfg.train.steps_per_epoch],
          "step_agreement": step_check, "k6": layer, "k7r": rollout_train,
          "steps": rows,
          "launches_per_step_expected": want_step,
          "cli": {"argv": ["test", name, "-n", str(n), "-c", ckpt], "lines": cli_lines},
          "checks": out["checks"]})
    return out


def device_busy(fn) -> dict:
    """``fn()`` once under ``torch.profiler``: its wall, the device's busy
    time (every kernel and copy on the card's timeline), their count and the
    idle share ``1 - busy / wall``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # a record_function range also shows on the device timeline; it is no
    # kernel and would count its span twice
    spans = [ev.time_range.elapsed_us() / 1e3 for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation]
    busy = sum(spans)
    return {"wall_ms": wall_ms, "device_launches": len(spans),
            "device_busy_ms": busy if spans else "not measured",
            "device_idle_share": 1 - busy / wall_ms if spans else "not measured"}


def cvrp_nls_args(root: Path, limit: int, ckpt: str | None = None, t_values=T_VALUES):
    """The CLI's ``test cvrp --local-search swapstar`` at CVRP_NLS_N on the
    first ``limit`` golden instances, A ants, seeds ``SEED + i``."""
    from deepaco_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["test", "cvrp", "-n", str(CVRP_NLS_N), "--local-search", "swapstar", "--ckpt",
         ckpt or str(root / CVRP_NLS_CKPT), "--limit", str(limit), "-a", str(A),
         "--seed", str(SEED), "-t", *map(str, t_values)])


def drive_cvrp_nls(args, ops=None, stats: dict | None = None):
    """One call of the CVRP-NLS path's entry point, ``cli._cmd_test_cvrp_ls``,
    its output captured: ``(means, curves [B, len(T)], lines)``."""
    import io

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.train.drivers import KERNEL_OPS

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        means, curves = cli._cmd_test_cvrp_ls(args, stats=stats, _ops=ops or KERNEL_OPS)
    return means, curves, text.getvalue().splitlines()


def cvrp_nls_phase(dev, root: Path, cuda_ms, timer_cls, counted) -> dict:
    """Phase 15, CVRP-NLS500 (``cvrp_nls500_selftrained``, 12 layers, the
    two-block graph at k = 5, the first CVRP_NLS_B golden instances, A ants,
    T_VALUES, seeds ``SEED + i``): the plain multi-block GNN pass timed; K7c
    at capacity 1.0 on the batch's neural scores and K8 on one instance's
    routes whose 8 cheapest ants the native engine rewrote, each against its
    plain version; the path in a kernel arm (K7c, K8) and a plain arm
    (``drivers.PLAIN_OPS``, the first CVRP_NLS_PLAIN_B instances), each with
    its costs, wall, phases, launches and every best route validated, and
    instance 0's kernel arm once more under the profiler for the device's
    idle share; one training step at the CVRP500-NLS envelope, the kernel
    arm against the plain arm on the same paths and LS costs; two steps of
    ``train_cvrp_nls``, saved and read back by the CLI. Emits three lines
    and returns what the kernels' line and the checks read."""
    import copy
    import types

    import numpy as np
    import torch

    from deepaco_tpu_torch.aco.engine import gumbel, path_log_probs
    from deepaco_tpu_torch.aco.problems.cvrp import cvrp_spec, route_cost, validate_routes
    from deepaco_tpu_torch.aco.problems.cvrp_nls import perturbation_metric
    from deepaco_tpu_torch.ops.rollout import RolloutShape
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.ls import hgs
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.train import drivers, special
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from deepaco_tpu_torch.utils.golden import cvrp_nls_test

    n_nodes, t_max = CVRP_NLS_N + 1, max(T_VALUES)
    out = {"checks": {}}
    net = Net.from_jax_variables(load_checkpoint(str(root / CVRP_NLS_CKPT))).to(dev)
    ds = cvrp_nls_test(CVRP_NLS_N, count=CVRP_NLS_B)
    dist = torch.as_tensor(ds["dist"], device=dev)
    demand = torch.as_tensor(ds["demand"], device=dev)

    # the plain multi-block GNN pass (no kernel takes a map of source rows),
    # batched as the CLI runs it and on one instance
    heuristic = lambda b: special.cvrp_nls_heuristic(net, demand[:b], dist[:b], 5, 1e-10)
    with torch.no_grad():
        heu = heuristic(CVRP_NLS_B)
        out["gnn_plain_ms"] = {f"B{b}": cuda_ms(lambda: heuristic(b), 3)
                               for b in (1, CVRP_NLS_B)}
    # K7c at capacity 1.0 on the normalised f32 demands
    score = score_matrix(torch.ones_like(heu), heu, 1.0, 1.0)
    out["k7c"] = check_cvrp_construct(dev, cuda_ms, score, demand, 1.0,
                                      f"cvrp_nls{CVRP_NLS_N}, neural heuristic, capacity 1")
    out["checks"]["k7c"] = out["k7c"]["passed"]
    # K7r at capacity 1.0 on instance 0's neural score, the training
    # envelope's ants (the CVRP-NLS step samples through K7c and replays
    # through path_log_probs; a facade's sample_nls takes K7r)
    gen_r = torch.Generator(device=dev).manual_seed(SEED + 14)
    ants = CVRP_NLS_TRAIN[0]
    out["k7r"] = check_rollout(
        cuda_ms, score[:1], torch.zeros((1, ants), dtype=torch.int64, device=dev),
        gumbel((2 * (n_nodes - 1), 1, ants, n_nodes), gen_r, dev),
        RolloutShape("cvrp", demand[:1], 1.0), f"cvrp_nls{CVRP_NLS_N}, capacity 1")
    out["checks"]["k7r"] = out["k7r"]["passed"]
    # K8 on instance 0's routes after the engine rewrote its 8 cheapest ants
    paths = cc.cvrp_construct(score[:1], demand[:1], 1.0, A,
                              torch.Generator(device=dev).manual_seed(SEED + 13))
    host = paths[0].cpu().numpy().copy()
    idx = np.argsort(route_cost(dist[:1], paths)[0].cpu().numpy())[:8]
    host[:, idx] = hgs.multiple_swap_star(
        ds["demand"][0].astype(np.float64), ds["dist"][0].astype(np.float64), host[:, idx],
        count=100000, heu_dist=perturbation_metric(heu[0].cpu().numpy()))
    rewritten = torch.from_numpy(host).to(dev)[None]
    out["k8"] = deposit_case(dev, cuda_ms, rewritten, 1.0 / route_cost(dist[:1], rewritten),
                             n_nodes, False)
    out["k8"]["rewritten_ants"] = int((rewritten != paths).any(dim=1).sum())
    emit({"phase": "kernel", "name": "tour_deposit", "config": f"cvrp_nls{CVRP_NLS_N} routes "
          "rewritten by the native engine", **out["k8"], "tolerance": "as phase 9"})
    out["checks"].update(k8=out["k8"]["passed"], k8_rewritten=out["k8"]["rewritten_ants"] > 0)
    del paths, rewritten, score

    # the path, the counts set to 0 just before each arm and read just after
    def arm(limit, ops):
        timer, stats = timer_cls(), {}
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, curves, lines = drive_cvrp_nls(cvrp_nls_args(root, limit),
                                              ops._replace(timer=timer), stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = stats["best"][..., None]
        valid = validate_routes(best, demand[:limit], 1.0)[:, 0]
        recost = route_cost(dist[:limit], best)[:, 0]
        return {"B": limit, "cost": means.tolist(), "per_instance": curves.tolist(),
                "wall_s": wall, "phase_ms": timer.ms(), "cli": lines,
                "launches": {fn.__name__: fn.launches for fn in counted},
                "finite": bool(torch.isfinite(curves).all())
                and curves.shape == (limit, len(T_VALUES)),
                "monotone": bool((curves[:, 1:] <= curves[:, :-1]).all()),
                "valid_best": int(valid.sum()),
                "best_cost_is_cost": bool(torch.allclose(recost, curves[:, -1], rtol=1e-5))}

    arms = {"kernel": arm(CVRP_NLS_B, drivers.KERNEL_OPS),
            "plain": arm(CVRP_NLS_PLAIN_B, drivers.PLAIN_OPS)}
    out["idle"] = device_busy(lambda: drive_cvrp_nls(cvrp_nls_args(root, 1)))
    kernel_only = {"cvrp_construct": 1, "tour_deposit": 1}
    want = {name: {fn.__name__: kernel_only.get(fn.__name__, 0) * r["B"] * t_max
                   * (name == "kernel") for fn in counted} for name, r in arms.items()}
    ck, cp = arms["kernel"]["per_instance"], arms["plain"]["per_instance"]
    four = lambda rows: [[round(c, 4) for c in row] for row in rows]
    out["checks"].update(
        arms=all(r["finite"] and r["monotone"] and r["valid_best"] == r["B"]
                 and r["best_cost_is_cost"] for r in arms.values()),
        launches=all(arms[a]["launches"] == want[a] for a in arms),
        # the same Philox noise, heuristic and engine: the first iteration's
        # routes are the same; later ones read K8's tau or scatter_add's,
        # which differ in their last bits
        t1_plain_equals_kernel=[row[0] for row in four(ck[:CVRP_NLS_PLAIN_B])]
        == [row[0] for row in four(cp)],
        t10_kernel_vs_plain=bool(abs(np.mean(ck[:CVRP_NLS_PLAIN_B], 0)[-1]
                                     - np.mean(cp, 0)[-1]) <= 0.01 * np.mean(cp, 0)[-1]),
        near_jax=all(abs(c - j) <= CVRP_NLS_SPAN * j
                     for c, j in zip(arms["kernel"]["cost"], JAX_CVRP_NLS_COSTS)))
    out["arms"] = arms
    phases = arms["kernel"]["phase_ms"]
    emit({"phase": "cvrp_nls_path", "B": CVRP_NLS_B, "N": n_nodes, "A": A, "T": list(T_VALUES),
          "ckpt": CVRP_NLS_CKPT, "jax_costs_first_4": JAX_CVRP_NLS_COSTS,
          "jax_full_set_anchors": CVRP_NLS_ANCHORS, "gnn_plain_ms": out["gnn_plain_ms"],
          "launches_per_iteration": kernel_only, "launches_expected": want,
          "t10_plain_equals_kernel": four(ck[:CVRP_NLS_PLAIN_B]) == four(cp),
          "local_search_share_of_wall": phases.get("local_search", 0.0)
          / (1e3 * arms["kernel"]["wall_s"]),
          "instance0_profiled": out["idle"], **arms})

    # training at the CVRP500-NLS envelope: one step, kernel arm (K7c)
    # against plain arm on the same paths and LS costs, the net in eval mode
    ants, lr, epochs, steps = CVRP_NLS_TRAIN
    cfg = special.cvrp_nls_config(CVRP_NLS_N, epochs=epochs, steps_per_epoch=steps, lr=lr,
                                  n_ants=ants, seed=SEED)
    gen_instance = special.cvrp_nls_instances(CVRP_NLS_N, SEED)
    gen_instance()
    dem1, dist1 = (torch.from_numpy(a)[None].to(dev) for a in gen_instance())
    state = tr.init_train_state(Net(feats=1).to(dev), cfg,
                                torch.Generator(device=dev).manual_seed(SEED))
    net_k, net_p = state.net, copy.deepcopy(state.net)
    before = copy.deepcopy(net_k.state_dict())
    for fn in counted:
        fn.launches = 0
    sampled = {}
    for name, net_arm, ops in (("kernel", net_k, drivers.KERNEL_OPS),
                               ("plain", net_p, drivers.PLAIN_OPS)):
        sample_fn, _ = special.make_cvrp_nls_train_fns(cfg, ops=ops)
        sampled[name] = sample_fn(net_arm, dem1, dist1,
                                  torch.Generator(device=dev).manual_seed(SEED + 14))
    step_launches = {fn.__name__: fn.launches for fn in counted}
    heu_k, paths_k, raw_k = sampled["kernel"]
    improved = hgs.multiple_swap_star(
        dem1[0].cpu().numpy().astype(np.float64), dist1[0].cpu().numpy().astype(np.float64),
        paths_k[0].cpu().numpy(), count=max(CVRP_NLS_N, 50),
        heu_dist=perturbation_metric(heu_k[0].cpu().numpy()))
    ls = route_cost(dist1, torch.from_numpy(improved).to(dev)[None])
    adv = ls - ls.mean(dim=-1, keepdim=True)
    losses = {name: special.cvrp_nls_loss(net_arm, dem1, dist1, sampled[name][1], adv,
                                          n_ants=ants)
              for name, net_arm in (("kernel", net_k), ("plain", net_p))}
    for loss in losses.values():
        loss.backward()
    with torch.no_grad():
        lp = path_log_probs(cvrp_spec(torch.ones_like(heu_k), heu_k, dem1, 1.0, ants), paths_k)
    arm_out = lambda name: types.SimpleNamespace(loss=losses[name], log_probs=lp,
                                                 mean_cost=ls.mean())
    step_check = step_agreement(cfg, net_k, net_p, before, arm_out("kernel"),
                                arm_out("plain"), adv)
    running_kept = all(torch.equal(before[k], v) for k, v in net_k.state_dict().items()
                       if "running" in k)
    same_paths = bool(torch.equal(paths_k, sampled["plain"][1]))
    valid = validate_routes(torch.from_numpy(improved).to(dev)[None], dem1, 1.0)
    del state, net_k, net_p, sampled
    # two steps of train_cvrp_nls, saved and read back by the CLI
    epochs_seen = []
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, trained = special.train_cvrp_nls(CVRP_NLS_N, epochs=epochs, steps_per_epoch=steps,
                                        lr=lr, n_ants=ants, seed=SEED,
                                        max_steps=CVRP_NLS_TRAIN_STEPS, device=dev,
                                        progress=lambda *a: epochs_seen.append(a))
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = {fn.__name__: fn.launches for fn in counted}
    ckpt = root / "build" / "chip_smoke" / f"cvrp_nls{CVRP_NLS_N}-chip.msgpack"
    save_checkpoint(str(ckpt), trained)
    tree = load_checkpoint(str(ckpt))
    reread_means, reread_curves, reread_lines = drive_cvrp_nls(
        cvrp_nls_args(root, 1, str(ckpt), t_values=(1,)))
    out["train_launches"] = train_launches
    out["checks"].update(
        step_agreement=step_check["passed"], train_same_paths=same_paths,
        train_running_stats_kept=running_kept, train_routes_valid=bool(valid.all()),
        train_step_launches=step_launches["cvrp_construct"] == 1
        and step_launches["fused_pick"] == 0,
        train_steps=trained.step == CVRP_NLS_TRAIN_STEPS and int(tree["step"])
        == CVRP_NLS_TRAIN_STEPS and len(epochs_seen) == 1
        and train_launches["cvrp_construct"] == CVRP_NLS_TRAIN_STEPS,
        reread=bool(np.isfinite(reread_means).all()) and reread_curves.shape == (1, 1))
    emit({"phase": "cvrp_nls_train", "B": 1, "N": n_nodes, "A": ants, "lr": lr,
          "weight_decay": cfg.train.weight_decay,
          "epochs_x_steps": [epochs, steps], "step_agreement": step_check,
          "raw_mean_cost": raw_k.mean().item(), "ls_mean_cost": ls.mean().item(),
          "step_launches": step_launches,
          "train_cvrp_nls": {"steps": CVRP_NLS_TRAIN_STEPS, "wall_s": train_wall,
                             "epochs": epochs_seen, "launches": train_launches,
                             "file": str(ckpt.relative_to(root)), "reread_lines": reread_lines},
          "checks": out["checks"]})
    return out


def rcpsp_args(*extra: str, limit: int | None = None, t_values=T_VALUES):
    """The CLI's ``test rcpsp -n 120`` on the archive's test split (its
    first ``limit``), A ants, the neural arm with ``rcpsp120_selftrained``
    unless ``extra`` says ``--classic`` or passes ``--ckpt``."""
    from deepaco_tpu_torch import cli

    argv = ["test", "rcpsp", "-n", str(RCPSP_N), "-a", str(A), "--seed", str(SEED),
            "-t", *map(str, t_values), *extra]
    if "--classic" not in extra and "--ckpt" not in extra:
        argv += ["--ckpt", str(Path(__file__).resolve().parent / RCPSP_CKPT)]
    if limit:
        argv += ["--limit", str(limit)]
    return cli.build_parser().parse_args(argv)


def write_psplib_archive(root: Path) -> Path:
    """RCPSP_INSTANCES seeded j120-shaped instances (122 activities, 4
    renewable resources, ProGen's parameters: ``core.rcpsp.progen_rcp``) as
    ``<root>/data/rcpsp/psplib.tar.gz``, the first 100 the test split."""
    import numpy as np

    from deepaco_tpu_torch.core import rcpsp as core

    rng = np.random.default_rng(SEED + RCPSP_N)
    path = root / "data" / "rcpsp" / "psplib.tar.gz"
    path.parent.mkdir(parents=True, exist_ok=True)
    core.write_psplib(str(path), [core.progen_rcp(rng, jobs=RCPSP_N)
                                  for _ in range(RCPSP_INSTANCES)], subset=f"j{RCPSP_N}rcp")
    return path


@contextlib.contextmanager
def reference_env(var: str, value: Path):
    """``os.environ[var] = value`` for the block, then as it was."""
    import os

    old = os.environ.get(var)
    os.environ[var] = str(value)
    try:
        yield
    finally:
        if old is None:
            del os.environ[var]
        else:
            os.environ[var] = old


def rcpsp_phase(dev, root: Path, cuda_ms, timer_cls, counted) -> dict:
    """Phase 17, RCPSP j120 (``rcpsp120_selftrained``, 12 layers, 32 units):
    the archive the smoke writes, K7r's untraced forward on one neural
    construction (the direct evaluation, SOP's kind) and K8 on an update's
    lists at the CLI's shapes (B=100, A=20, n=122), the CLI's ``test rcpsp
    -n 120`` in four arms (kernel, plain, classic, ``--backfill``), one
    training step kernel arm against plain arm with K7r on its rollout,
    ``train rcpsp -n 120 -e 1 -s 2`` and ``test rcpsp --ckpt`` of what it
    wrote, and the blend (``RCPSPACO`` with RCPSP_BLEND on the first test
    instance, RCPSP_BLEND_T iterations): K7r's untraced forward (the
    ``"blend"`` kind) once an iteration, held against its plain version on
    one more construction's inputs, and one ``rcpsp_loss`` step under the
    blend, kernel arm against plain arm, K7r once each way, held on its
    rollout. Emits a line for the path, one for training and one for the
    blend; returns what the kernels' line and the checks read."""
    import io
    import copy
    import tempfile

    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems import rcpsp as apr
    from deepaco_tpu_torch.core.rcpsp import check_schedule, load_psplib, stack_rcpsp
    from deepaco_tpu_torch.eval.rcpsp import rcpsp_heuristics, rcpsp_net
    from deepaco_tpu_torch.train import drivers, special
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint

    tmp = Path(tempfile.mkdtemp(dir=root / "build"))
    archive = write_psplib_archive(tmp)
    test = load_psplib(str(archive), f"j{RCPSP_N}rcp", device=dev)
    train = load_psplib(str(archive), f"j{RCPSP_N}rcp", split="train", device=dev)
    data = stack_rcpsp(test)
    n = data.n
    out = {"checks": {}}

    # K7r's untraced forward on one construction (the neural heuristic, tau
    # of ones), K8 on the first update's deposit: the best-so-far list and
    # the iteration-best (elitist), directed, no wraparound
    net = rcpsp_net(load_checkpoint(str(root / RCPSP_CKPT))).to(dev)
    with torch.no_grad():
        heu = rcpsp_heuristics(data, net)
    cfg = apr.RCPSPConfig(n_ants=A, elitist=True, min_max=True)
    spec = apr.rcpsp_spec(torch.ones_like(heu), heu, data, cfg)
    captured = []
    with torch.no_grad(), captured_rollouts(captured):
        paths = rollout(spec, torch.Generator(device=dev).manual_seed(SEED + 17)).paths
        costs = apr.makespans(data, paths)
    out["k7r_paths"] = check_rollout_paths(cuda_ms, *captured[0], f"rcpsp{RCPSP_N} inference "
                                           f"rollout, B={len(test)}, A={A}")
    it = torch.argmin(costs, dim=-1)
    best = paths.gather(-1, it[:, None, None].expand(-1, n, 1))
    dep_paths = torch.cat([best, best], dim=-1)
    amounts = (1.0 / costs.gather(-1, it[:, None])).expand(-1, 2).contiguous()
    out["k8"] = deposit_case(dev, cuda_ms, dep_paths, amounts, n, False)
    out["k8"]["below_library"] = out["k8"]["ms"] < out["k8"]["library_ms"]
    emit({"phase": "kernel", "name": "tour_deposit", "config": f"rcpsp{RCPSP_N} update, the "
          "best-so-far and the iteration-best lists", **out["k8"], "tolerance": "as phase 9"})
    out["checks"].update(k7r_paths=out["k7r_paths"]["passed"], k8=out["k8"]["passed"])
    del heu, spec, paths, costs, captured

    # the path through the CLI in four arms, the counts set to 0 just before
    # each and read just after
    def arm(args, ops):
        timer, stats = timer_cls(), {}
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text = io.StringIO()
        with reference_env("DEEPACO_REFERENCE_ROOT", tmp), contextlib.redirect_stdout(text):
            means, curves = cli._cmd_test_rcpsp(args, stats=stats,
                                                _ops=ops._replace(timer=timer))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        starts = apr.ssgs_schedule(stats["data"], stats["best"][:, None], args.backfill)[:, 0]
        feasible = sum(check_schedule(d, s) for d, s in zip(test, starts.cpu()))
        return {"cost": [float(v) for v in means], "wall_s": wall, "phase_ms": timer.ms(),
                "cli": text.getvalue().splitlines(),
                "launches": {fn.__name__: fn.launches for fn in counted},
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "finite": bool(torch.isfinite(curves).all()),
                "monotone": bool((curves[:, 1:] <= curves[:, :-1]).all()),
                "feasible_best": int(feasible),
                "best_is_makespan": bool(torch.equal(starts[:, -1].float(), curves[:, -1]))}

    arms = {"kernel": arm(rcpsp_args(), drivers.KERNEL_OPS),
            "plain": arm(rcpsp_args(), drivers.PLAIN_OPS),
            "classic": arm(rcpsp_args("--classic"), drivers.KERNEL_OPS),
            "backfill": arm(rcpsp_args("--backfill"), drivers.KERNEL_OPS)}
    t_max = max(T_VALUES)
    on = {"fused_rollout_paths": t_max, "tour_deposit": t_max}
    want = {a: {fn.__name__: (0 if a == "plain" else on.get(fn.__name__, 0)) for fn in counted}
            for a in arms}
    ck, cp = arms["kernel"]["cost"], arms["plain"]["cost"]
    b = len(test)
    out["checks"].update(
        arms=all(r["finite"] and r["monotone"] and r["feasible_best"] == b
                 and r["best_is_makespan"] for r in arms.values()),
        launches=all(arms[a]["launches"] == want[a] for a in arms),
        # the same noise: only the plain pick's logsumexp order could part
        # them, and it does not move an argmax
        t1_kernel_vs_plain=abs(ck[0] - cp[0]) <= 1e-4 * cp[0],
        t10_kernel_vs_plain=abs(ck[-1] - cp[-1]) <= 0.01 * cp[-1])
    # the kernel arm's first iteration once more under the profiler: the
    # device's idle share
    with reference_env("DEEPACO_REFERENCE_ROOT", tmp), contextlib.redirect_stdout(io.StringIO()):
        idle = device_busy(lambda: cli._cmd_test_rcpsp(rcpsp_args(t_values=(1,))))
    emit({"phase": "rcpsp_path", "B": b, "N": n, "A": A, "T": list(T_VALUES),
          "ckpt": RCPSP_CKPT, "t_max": data.t_max, "archive": "seeded ProGen j120 "
          "(progen_rcp, RF 0.5, RS 0.3)", "launches_expected": want,
          "kernel_arm_t1_under_profiler": idle, **arms})
    out["arms"] = arms

    # training: (a) one step from the seed's weights on the first train
    # instance, the kernel arm (K7r each way) against the plain arm replaying
    # its paths, K7r on its rollout; (b) the CLI's train rcpsp, cut to 2
    # steps, and its test
    cfg_t = special.rcpsp_config(n, n_ants=A, lr=3e-4)
    one = stack_rcpsp(train[:1], max(d.t_max for d in train))
    net_k = special.init_train_state(rcpsp_net().to(dev), cfg_t,
                                     torch.Generator(device=dev).manual_seed(SEED)).net
    net_p = copy.deepcopy(net_k)
    before = copy.deepcopy(net_k.state_dict())
    train_rollouts = []
    aco = apr.RCPSPConfig(n_ants=A)
    with captured_rollouts(train_rollouts):
        out_k = special.rcpsp_loss(net_k, one, aco,
                                   torch.Generator(device=dev).manual_seed(SEED))
    out_k.loss.backward()
    out_p = special.rcpsp_loss(net_p, one, aco, torch.Generator(device=dev), paths=out_k.paths,
                               _ops=drivers.PLAIN_OPS)
    out_p.loss.backward()
    adv = out_k.costs - out_k.costs.mean(dim=-1, keepdim=True)
    step = step_agreement(cfg_t, net_k, net_p, before, out_k, out_p, adv / n)
    rollout_train = check_rollout(cuda_ms, *train_rollouts[0],
                                  f"rcpsp{RCPSP_N} training rollout, {A} ants")
    del train_rollouts
    ckpt = root / "build" / "chip_smoke" / f"rcpsp{RCPSP_N}_trained.msgpack"
    ckpt.unlink(missing_ok=True)
    for fn in counted:
        fn.launches = 0
    text = io.StringIO()
    t0 = time.perf_counter()
    with reference_env("DEEPACO_REFERENCE_ROOT", tmp), contextlib.redirect_stdout(text):
        cli.main(["train", "rcpsp", "-n", str(RCPSP_N), "-e", "1",
                  "-s", str(RCPSP_TRAIN_STEPS), "-a", str(A), "-o", str(ckpt)])
        train_wall = time.perf_counter() - t0
        train_launches = {fn.__name__: fn.launches for fn in counted}
        reread, _ = cli._cmd_test_rcpsp(rcpsp_args("--ckpt", str(ckpt), limit=4, t_values=(1,)))
    train_lines = text.getvalue().splitlines()
    tree = load_checkpoint(str(ckpt))
    out["checks"].update(
        step_agreement=step["passed"], k7r_train=rollout_train["passed"],
        train_launches=train_launches["fused_rollout"] == RCPSP_TRAIN_STEPS
        and train_launches["fused_rollout_backward"] == RCPSP_TRAIN_STEPS
        and sum(train_launches.values()) == 2 * RCPSP_TRAIN_STEPS,
        train_checkpoint=int(tree["step"]) == RCPSP_TRAIN_STEPS
        and tree["params"]["emb_net"]["v_lin0"]["kernel"].shape == (5, 32),
        reread_finite=all(math.isfinite(v) for v in reread))
    emit({"phase": "rcpsp_train", "N": n, "A": A, "lr": cfg_t.train.lr,
          "weight_decay": cfg_t.train.weight_decay, "clip": cfg_t.train.grad_clip,
          "step_agreement": step, "k7r": rollout_train, "cli_wall_s": train_wall,
          "cli_launches": train_launches, "cli_lines": train_lines,
          "reread_cost_t1": [float(v) for v in reread], "checks": out["checks"]})
    out["rollout_train"], out["train_launches"] = rollout_train, train_launches

    # the blend on K7r's "blend" kind: RCPSPACO on the first test instance,
    # the counts set to 0 just before its run and read just after; then K7r's
    # untraced forward on the inputs of one more construction on its
    # pheromone, held against its plain version
    blend = apr.RCPSPACO(test[0], n_ants=A, seed=SEED, device=dev, **RCPSP_BLEND)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blend_best = float(blend.run(RCPSP_BLEND_T))
    torch.cuda.synchronize()
    blend_wall = time.perf_counter() - t0
    blend_launches = {fn.__name__: fn.launches for fn in counted}
    bspec = apr.rcpsp_spec(blend.state.tau, blend.heuristic, blend.data, blend.cfg)
    captured = []
    with torch.no_grad(), captured_rollouts(captured):
        rollout(bspec, torch.Generator(device=dev).manual_seed(SEED + 18))
    out["k7r_blend_paths"] = check_rollout_paths(
        cuda_ms, *captured[0], f"rcpsp{RCPSP_N} blend {RCPSP_BLEND} inference rollout, B=1, "
        f"A={A}")
    del captured
    route, starts, makespan = blend.best_solution
    blend_want = {fn.__name__: 0 for fn in counted}
    blend_want.update(fused_rollout_paths=RCPSP_BLEND_T, tour_deposit=RCPSP_BLEND_T)
    out["blend"] = {"launches": blend_launches, "wall_s": blend_wall, "best": blend_best,
                    **RCPSP_BLEND, "T": RCPSP_BLEND_T, "A": A, "N": n}

    # one training step under the blend from the seed's weights on the first
    # train instance: the kernel arm (K7r's blend kind each way, the counts
    # read after its backward) against the plain arm replaying its paths,
    # K7r on its rollout's own inputs
    aco_b = apr.RCPSPConfig(n_ants=A, **RCPSP_BLEND)
    net_bk = special.init_train_state(rcpsp_net().to(dev), cfg_t,
                                      torch.Generator(device=dev).manual_seed(SEED)).net
    net_bp = copy.deepcopy(net_bk)
    before_b = copy.deepcopy(net_bk.state_dict())
    blend_rollouts = []
    for fn in counted:
        fn.launches = 0
    with captured_rollouts(blend_rollouts):
        out_bk = special.rcpsp_loss(net_bk, one, aco_b,
                                    torch.Generator(device=dev).manual_seed(SEED + 19))
    out_bk.loss.backward()
    torch.cuda.synchronize()
    blend_step_launches = {fn.__name__: fn.launches for fn in counted}
    out_bp = special.rcpsp_loss(net_bp, one, aco_b, torch.Generator(device=dev),
                                paths=out_bk.paths, _ops=drivers.PLAIN_OPS)
    out_bp.loss.backward()
    adv_b = out_bk.costs - out_bk.costs.mean(dim=-1, keepdim=True)
    step_b = step_agreement(cfg_t, net_bk, net_bp, before_b, out_bk, out_bp, adv_b / n)
    out["rollout_blend_train"] = check_rollout(cuda_ms, *blend_rollouts[0],
                                               f"rcpsp{RCPSP_N} blend {RCPSP_BLEND} training "
                                               f"rollout, {A} ants")
    del blend_rollouts
    step_want = {fn.__name__: 0 for fn in counted}
    step_want.update(fused_rollout=1, fused_rollout_backward=1)
    out["blend_step_launches"] = blend_step_launches
    out["checks"].update(
        blend_k7r_paths=out["k7r_blend_paths"]["passed"],
        blend_launches=blend_launches == blend_want,
        blend_feasible=bool(check_schedule(test[0], torch.as_tensor(starts)))
        and makespan == blend_best and math.isfinite(blend_best),
        blend_step_agreement=step_b["passed"], blend_k7r_train=out["rollout_blend_train"]["passed"],
        blend_step_launches=blend_step_launches == step_want)
    emit({"phase": "rcpsp_blend", **out["blend"], "launches_expected": blend_want,
          "k7r_paths": out["k7r_blend_paths"], "step_agreement": step_b,
          "step_launches": blend_step_launches, "step_launches_expected": step_want,
          "k7r_train": out["rollout_blend_train"], "checks": out["checks"]})
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def k7_past_caps_run(dev, cuda_ms, counted) -> dict:
    """K7's route past K7r's caps: the ACO facade (``aco.runner.ACO``) on one
    seeded U(0,1)^2 TSP instance of K7_PAST_N > FUSED_ROLLOUT_MAX_N nodes,
    A ants, the classic heuristic ``1/d``, no local search, K7_PAST_T
    iterations, the counts set to 0 just before and read just after: K7 a
    step (N - 1 an iteration) and K8 once an iteration, nothing else, and
    a best tour that is a permutation and costs what the run reports. Then
    K7 against ``fused_pick_plain`` on the rows of one more construction on
    its pheromone, at the shares FAMILY_PICK_AT of the horizon. Emits one
    line; returns what the kernels' line and the checks read."""
    import torch

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.aco.runner import ACO
    from deepaco_tpu_torch.ops import pick
    from deepaco_tpu_torch.ops.rollout import FUSED_ROLLOUT_MAX_N
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    n = K7_PAST_N
    coords = uniform_coords(n, torch.Generator(device=dev).manual_seed(SEED + 46), device=dev)
    dist = distance_matrix(coords)
    aco = ACO(dist, n_ants=A, seed=SEED, device=dev)
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    best = float(aco.run(K7_PAST_T))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    want = {fn.__name__: 0 for fn in counted}
    want.update(fused_pick=K7_PAST_T * (n - 1), tour_deposit=K7_PAST_T)
    tour = aco.best_path
    permutation = bool(torch.equal(torch.sort(tour).values, torch.arange(n, device=dev)))
    tour_len = float(tour_cost(dist, tour[:, None])[0])
    spec = aco.spec(aco.state.phe.tau, aco.heuristic)
    at = {int(f * spec.horizon) for f in FAMILY_PICK_AT}
    steps, rows = iter(range(spec.horizon)), []

    def capture(score, mask, noise):
        if next(steps) in at:
            rows.append((len(rows), score.clone(), mask.clone(), noise.clone()))
        return pick.fused_pick(score, mask, noise)

    with torch.no_grad():
        rollout(spec, torch.Generator(device=dev).manual_seed(SEED + 47), pick=capture)
    k7 = check_pick_rows(cuda_ms, rows, FAMILY_PICK_AT)
    out = {"N": n, "A": A, "T": K7_PAST_T, "above_cap": n > FUSED_ROLLOUT_MAX_N,
           "launches": launches, "launches_expected": want, "wall_s": wall, "best": best,
           "k7": k7, "dist_gb": dist.numel() * 4 / 1e9}
    out["checks"] = {"above_cap": out["above_cap"], "launches": launches == want,
                     "permutation": permutation, "best_is_tour_cost":
                     abs(tour_len - best) <= 1e-4 * best, "k7": k7["passed"]}
    emit({"phase": "k7_past_caps", **out})
    return out


def tsp_golden_args(root: Path, *extra: str, limit: int | None = None, t_values=T_VALUES):
    """The CLI's ``test tsp -n 500`` on the golden file the smoke writes, A
    ants; ``extra`` carries the arm's flags and checkpoint."""
    from deepaco_tpu_torch import cli

    argv = ["test", "tsp", "-n", str(N), "-a", str(A), "--seed", str(SEED),
            "-t", *map(str, t_values), *extra]
    if limit:
        argv += ["--limit", str(limit)]
    return cli.build_parser().parse_args(argv)


def tsp_golden_phase(dev, root: Path, cuda_ms, counted, coords) -> dict:
    """Phase 18, ``test tsp`` on a golden file: ``testDataset-500.pt``
    written from the main path's first TSP_GOLDEN_B instances under
    ``$DEEPACO_REFERENCE_DATA``; K7r's untraced forward, K4, K5 and K8 at
    the facade's shapes (one instance, 20 ants, N=500: one construction
    from city 0 on the NLS heuristic, its tours, their cyclic deposit); then four
    commands: the family path (``tsp500_selftrained``), ``--local-search
    nls`` batched and ``--per-instance`` (``tsp_nls500_selftrained``), and
    ``--local-search 2opt --classic --per-instance``. Emits one line and
    returns what the kernels' line and the checks read."""
    import io
    import tempfile

    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco.runner import ACO
    from deepaco_tpu_torch.core.builders import start_node_features
    from deepaco_tpu_torch.eval.anytime import dense_heuristic
    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.models.gnn import Net
    from deepaco_tpu_torch.ops import two_opt
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    tmp = Path(tempfile.mkdtemp(dir=root / "build"))
    (tmp / "tsp").mkdir()
    torch.save(coords[:TSP_GOLDEN_B].cpu().clone(), tmp / "tsp" / f"testDataset-{N}.pt")
    out = {"checks": {}}

    # the facade's shapes: instance 0, the NLS heuristic, one construction
    c0 = coords[:1]
    d0 = distance_matrix(c0)
    nls_net = Net.from_jax_variables(load_checkpoint(str(root / NLS_CKPT))).to(dev)
    heu0 = dense_heuristic(nls_net, start_node_features(c0), c0, d0, K)
    aco = ACO(d0[0], n_ants=A, heuristic=heu0[0], local_search="nls", coords=c0[0], seed=SEED,
              device=dev)
    captured = []
    with torch.no_grad(), captured_rollouts(captured):
        paths = rollout(aco.spec(aco.state.phe.tau, aco.heuristic), aco.generator).paths
    out["k7r_paths"] = check_rollout_paths(cuda_ms, *captured[0],
                                           "tsp500 facade rollout, B=1, A=20, from city 0")
    del captured
    tours = paths.transpose(1, 2).contiguous()
    hd = two_opt.heuristic_dist(aco.heuristic)
    ls = {}
    for name, kern, plain, args, metric_bytes in (
            ("batched_two_opt_euclid", two_opt.batched_two_opt_euclid,
             two_opt.batched_two_opt_euclid_plain, (c0, tours, ACO.LS_BUDGET), 0),
            ("batched_nls_euclid", two_opt.batched_nls_euclid, two_opt.batched_nls_euclid_plain,
             (c0, hd, tours, ACO.LS_BUDGET), 2 * N * N)):
        got = kern(*args)
        scans = {}
        want = plain(*args, scans=scans)
        ok = bool(torch.equal(got, want))
        ls[name] = {"B": 1, "A": A, "N": N, "passed": ok, "scans": scans,
                    "max_abs_err": (got - want).abs().max().item(),
                    "ms": cuda_ms(lambda: kern(*args), 3),
                    "plain_ms": cuda_ms(lambda: plain(*args), 1), "library_ms": None,
                    **dict(zip(("bound_ms", "bound_by"), ls_bound(N, 1, A, scans,
                                                                  metric_bytes)))}
        emit({"phase": "kernel", "name": name, "config": "tsp500 facade, one instance",
              **ls[name], "tolerance": "tours exactly equal"})
        out["checks"][name] = ok
    improved = two_opt.batched_nls_euclid(c0, hd, tours, ACO.LS_BUDGET).transpose(1, 2)
    cost = aco.cost(improved)
    out["k8"] = deposit_case(dev, cuda_ms, improved, 1.0 / cost, N, True)
    emit({"phase": "kernel", "name": "tour_deposit", "config": "tsp500 facade update, cyclic",
          **out["k8"], "tolerance": "as phase 9"})
    out["checks"].update(k7r_paths=out["k7r_paths"]["passed"], k8=out["k8"]["passed"])
    out["ls"] = ls
    del aco, heu0, paths, tours, improved

    # the four commands, the counts set to 0 just before each and read
    # just after
    def run(args, fn):
        stats = {}
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        text = io.StringIO()
        with reference_env("DEEPACO_REFERENCE_DATA", tmp), contextlib.redirect_stdout(text):
            means, curves = fn(args, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = stats["best"]
        ident = torch.arange(N, device=dev).expand_as(best)
        return {"cost": [float(v) for v in means], "wall_s": wall,
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "curves_t1": curves[:, 0].tolist(), "cli": text.getvalue().splitlines(),
                "launches": {k.__name__: k.launches for k in counted},
                "permutations": int((torch.sort(best, dim=-1).values == ident).all(-1).sum()),
                "B": int(best.shape[0]),
                "monotone": bool((curves[:, 1:] <= curves[:, :-1]).all())}

    tsp_ckpt, nls = str(root / CKPT), ["--local-search", "nls", "--ckpt", str(root / NLS_CKPT)]
    per = dict(limit=TSP_PER_B, t_values=TSP_PER_T)
    arms = {
        "tsp_family": run(tsp_golden_args(root, "--ckpt", tsp_ckpt), cli._cmd_test_family),
        "tsp_nls_batched": run(tsp_golden_args(root, *nls), cli._cmd_test_tsp_ls),
        "tsp_nls_per_instance": run(tsp_golden_args(root, *nls, "--per-instance", **per),
                                    cli._cmd_test_tsp_ls),
        "tsp_2opt_per_instance": run(tsp_golden_args(
            root, "--local-search", "2opt", "--classic", "--per-instance", **per),
            cli._cmd_test_tsp_ls)}
    t_max, t_per = max(T_VALUES), TSP_PER_B * max(TSP_PER_T)
    # the TSP inference rollouts: one K7r untraced launch an iteration
    want = {"tsp_family": {"embnet_layers": 1, "fused_rollout_paths": t_max,
                           "tour_deposit": t_max},
            "tsp_nls_batched": {"tsp_dense_heuristic": 1, "dense_sweep_fused": t_max,
                                "batched_nls_euclid": t_max, "fused_tsp_update": t_max},
            "tsp_nls_per_instance": {"tsp_dense_heuristic": 1, "fused_rollout_paths": t_per,
                                     "batched_nls_euclid": t_per, "tour_deposit": t_per},
            "tsp_2opt_per_instance": {"fused_rollout_paths": t_per,
                                      "batched_two_opt_euclid": t_per, "tour_deposit": t_per}}
    launches_ok = {}
    for key, r in arms.items():
        launches_ok[key] = all(r["launches"][k] == want[key].get(k, 0) for k in r["launches"])
    # the family path's plain arm (drivers.PLAIN_OPS: the plain K9, the
    # plain step loop, the plain deposit) on the same instances, net and
    # seed, hence the same noise
    fam_args = tsp_golden_args(root, "--ckpt", tsp_ckpt)
    with reference_env("DEEPACO_REFERENCE_DATA", tmp):
        fam_ds = cli.golden_set("tsp", N, None)
    fam_plain, _ = drivers.evaluate_family(
        "tsp", fam_ds, n_nodes=N, net=cli._load_net(fam_args), k_sparse=fam_args.k_sparse,
        n_ants=A, t_values=T_VALUES, seed=SEED, device=dev, _ops=drivers.PLAIN_OPS)
    fam_plain = [float(v) for v in fam_plain]
    fam_kernel = arms["tsp_family"]["cost"]
    # the family path's first iteration once more under the profiler
    with reference_env("DEEPACO_REFERENCE_DATA", tmp), contextlib.redirect_stdout(io.StringIO()):
        idle = device_busy(lambda: cli._cmd_test_family(
            tsp_golden_args(root, "--ckpt", tsp_ckpt, t_values=(1,))))
    batched_t1 = sum(arms["tsp_nls_batched"]["curves_t1"][:TSP_PER_B]) / TSP_PER_B
    per_t1 = arms["tsp_nls_per_instance"]["cost"][0]
    out["checks"].update(
        permutations=all(r["permutations"] == r["B"] for r in arms.values()),
        monotone=all(r["monotone"] for r in arms.values()),
        launches=all(launches_ok.values()),
        per_instance_vs_batched_nls=abs(per_t1 - batched_t1) <= 0.02 * batched_t1,
        family_t1_kernel_vs_plain=abs(fam_kernel[0] - fam_plain[0]) <= 1e-4 * fam_plain[0],
        family_t10_kernel_vs_plain=abs(fam_kernel[-1] - fam_plain[-1]) <= 0.01 * fam_plain[-1])
    emit({"phase": "tsp_golden", "B": TSP_GOLDEN_B, "per_instance_B": TSP_PER_B, "N": N,
          "A": A, "launches_expected": want, "launches_ok": launches_ok,
          "nls_t1_first4": {"batched": batched_t1, "per_instance": per_t1},
          "tsp_family_plain_cost": fam_plain,
          "family_t1_under_profiler": idle, **arms})
    out["arms"] = arms
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def reference_state_dict(net, extra_head: bool = False) -> dict:
    """``net``'s weights under the reference's ``state_dict`` names, as its
    ``pretrained/*.pt`` files hold them: a GNN's BatchNorm entries under
    ``.module.`` with ``num_batches_tracked`` added, and ``extra_head`` a
    copy of the heuristic head as ``par_net_phe`` (which a single-head net
    does not read), and without the node BatchNorms a net without the node
    update never reads; the transformer's under ``transformer_encoder.
    layers.<i>.self_attn.*`` and ``decoder_heu.lins.<i>``
    (mkp_transformer/net.py)."""
    import torch

    attn = {"in_proj_w": "self_attn.in_proj_weight", "in_proj_b": "self_attn.in_proj_bias",
            "out_proj.weight": "self_attn.out_proj.weight",
            "out_proj.bias": "self_attn.out_proj.bias"}
    emb = getattr(net, "emb_net", None)
    unread = () if emb is None or emb.node_update else ("emb_net.v_bns.",)
    sd = {}
    for name, t in net.state_dict().items():
        if name.startswith(unread):
            continue
        t = t.detach().cpu().clone()
        parts = name.split(".")
        if parts[0] == "layers":
            rest = ".".join(parts[2:])
            sd[f"transformer_encoder.layers.{parts[1]}.{attn.get(rest, rest)}"] = t
        elif parts[0] == "head":
            sd[f"decoder_heu.lins.{parts[1]}.{parts[2]}"] = t
        elif len(parts) == 4 and parts[1] in ("v_bns", "e_bns"):
            module = ".".join(parts[:3]) + ".module"
            sd[f"{module}.{parts[3]}"] = t
            sd[f"{module}.num_batches_tracked"] = torch.tensor(0)
        else:
            sd[name] = t
            if extra_head and parts[0] == "par_net_heu":
                sd["par_net_phe." + ".".join(parts[1:])] = t.clone()
    return sd


def remaining_phase(dev, root: Path, cuda_ms, counted, net, coords, main_wall: float) -> dict:
    """Phase 19, the remaining single-card paths, each run with the kernels'
    counts set to 0 just before it and read just after:

    (a) reference ``.pt`` checkpoints: ``cvrp500_selftrained`` (with an
        extra head) and ``mkp_items500_selftrained`` written under the
        reference's names, then ``test cvrp -n 500`` and ``test mkp_items
        -n 500`` through the CLI with ``--ckpt`` the ``.pt`` and the
        msgpack; ``save_params_npz`` of the CVRP net read from the ``.pt``;
    (b) ``AdaptiveCVRPACO`` on the first ADAPTIVE_B golden CVRP500
        instances (``1/d``, seeds 0-3) beside ``CVRPACO(elitist=True)``,
        an iteration at a time; K7c at its B=1 shape and K8 on its rewritten
        routes against their plain versions;
    (c) ``run_anytime_sparse`` at the main path's inputs on K1's heuristic,
        kernel and plain arms; K3 with its f32 score against its plain
        version on the runner's first iteration;
    (d) ``make_mkp_items_train_step`` at MKP-items 500's envelope: the
        family loss it runs, kernel arm against plain arm on the same paths
        (phase 7's tolerances), then the step itself.
    Emits one line and returns what the kernels' line and the checks read."""
    import copy
    import io
    import tempfile

    import numpy as np
    import torch

    from deepaco_tpu_torch import cli
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.adaptive_cvrp import AdaptiveCVRPACO
    from deepaco_tpu_torch.aco.problems.cvrp import CVRPACO, route_cost, validate_routes
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.aco.runner import ACOConfig, track_best
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.families import CVRP_CAPACITY, get_family
    from deepaco_tpu_torch.models.gnn import to_jax_variables
    from deepaco_tpu_torch.train import drivers, special
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_params_npz
    from deepaco_tpu_torch.utils.datasets import distance_matrix
    from deepaco_tpu_torch.utils.golden import GOLDEN

    tmp = Path(tempfile.mkdtemp(dir=root / "build"))
    out = {"checks": {}}
    checks = out["checks"]

    def zero():
        for k in counted:
            k.launches = 0
        torch.cuda.synchronize()

    def counts():
        return {k.__name__: k.launches for k in counted}

    def only(got: dict, want: dict) -> bool:
        return all(v == want.get(k, 0) for k, v in got.items())

    # (a) reference .pt checkpoints through the CLI
    t_max = max(T_VALUES)
    cli_arms, cli_want = {}, {"cvrp": {"embnet_layers": 1, "cvrp_construct": t_max,
                                       "tour_deposit": t_max},
                              "mkp_items": {"fused_rollout_paths": t_max}}
    for name in ("cvrp", "mkp_items"):
        n, ckpt = FAMILY_PATHS[name][:2]
        pt = tmp / f"{name}{n}.pt"
        torch.save(reference_state_dict(drivers.family_model(
            get_family(name), load_checkpoint(str(root / ckpt))), extra_head=name == "cvrp"), pt)
        for kind, path in (("pt", pt), ("msgpack", root / ckpt)):
            args = cli.build_parser().parse_args(
                ["test", name, "-n", str(n), "-a", str(A), "--seed", str(SEED),
                 "-t", *map(str, T_VALUES), "--ckpt", str(path)])
            zero()
            t0 = time.perf_counter()
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                means, _ = cli._cmd_test_family(args)
            torch.cuda.synchronize()
            cli_arms[f"{name}_{kind}"] = {
                "cost": [float(v) for v in means], "wall_s": time.perf_counter() - t0,
                "launches": counts(), "cost_lines": text.getvalue().splitlines()[1:-1]}
        got, want = cli_arms[f"{name}_pt"], cli_arms[f"{name}_msgpack"]
        checks[f"{name}_pt_equals_msgpack"] = got["cost_lines"] == want["cost_lines"]
        checks[f"{name}_pt_launches"] = only(got["launches"], cli_want[name])
        checks[f"{name}_msgpack_launches"] = only(want["launches"], cli_want[name])
    npz_net = drivers.family_model(get_family("cvrp"), cli.read_variables(
        str(tmp / f"cvrp{FAMILY_PATHS['cvrp'][0]}.pt")))
    save_params_npz(str(tmp / "cvrp.npz"), to_jax_variables(npz_net)["params"])
    flat = {}

    def walk(node, keys):
        if isinstance(node, dict):
            for key, value in node.items():
                walk(value, (*keys, key))
        else:
            flat["/".join(keys)] = np.asarray(node)

    walk(load_checkpoint(str(root / CVRP_CKPT))["params"], ())
    with np.load(tmp / "cvrp.npz") as npz:
        checks["npz_names_and_arrays"] = (set(npz.files) == set(flat) and all(
            np.array_equal(npz[k], flat[k]) for k in flat))
        out["npz_arrays"] = len(npz.files)
    del npz_net

    # (b) the adaptive-elitist CVRP baseline beside the elitist facade
    ds = GOLDEN["cvrp"](CVRP_N)
    adaptive, elitist = [], []
    for i in range(ADAPTIVE_B):
        d, dem = ds["dist"][i], ds["demand"][i]
        aco = AdaptiveCVRPACO(d, dem, capacity=CVRP_CAPACITY, n_ants=A, seed=i, device=dev)
        zero()
        t0 = time.perf_counter()
        curve, improved = [], 0
        for _ in range(t_max):
            before = aco.best_cost.item()
            aco.run(1)
            curve.append(aco.best_cost.item())
            improved += curve[-1] < before
        wall = time.perf_counter() - t0
        launches = counts()
        best = aco.best_path[None, :, None]
        recost = route_cost(aco.distances, best)[0, 0].item()
        adaptive.append({
            "curve": curve, "wall_s": wall, "launches": launches,
            "improved_iterations": improved, "elite_pool": len(aco.elite_pool),
            "valid": bool(validate_routes(best, aco.demand, CVRP_CAPACITY)[0, 0]),
            "route_cost": recost,
            "launches_ok": only(launches, {"cvrp_construct": t_max, "tour_deposit": improved}),
            "cost_is_route_cost": abs(recost - curve[-1]) <= 1e-4 * curve[-1]})
        el = CVRPACO(d, dem, capacity=CVRP_CAPACITY, n_ants=A, elitist=True, seed=i, device=dev)
        zero()
        t0 = time.perf_counter()
        el_curve = [el.run(1).item() for _ in range(t_max)]
        elitist.append({"curve": el_curve, "wall_s": time.perf_counter() - t0,
                        "launches": counts()})
        if i == 0:
            # K7c at the facade's B=1 shape on its last pheromone, K8 on the
            # iteration's routes after the improvement phase (elitist: one ant)
            k7c = check_cvrp_construct(dev, cuda_ms, score_matrix(aco.state.phe.tau, aco.heuristic,
                                                                  1.0, 1.0),
                                       aco.demand, CVRP_CAPACITY, "adaptive cvrp500, B=1")
            paths = aco.construct(aco.state.phe.tau, aco.heuristic, aco.generator)
            costs = aco.cost(paths)[0].cpu().numpy().copy()
            host, costs = aco.improvement_phase(paths[0].cpu().numpy().copy(), costs)
            j = int(np.argmin(costs))
            k8 = deposit_case(dev, cuda_ms, torch.as_tensor(host[:, j:j + 1], device=dev)[None],
                              torch.tensor([[1.0 / costs[j]]], device=dev), CVRP_N + 1, False)
            emit({"phase": "kernel", "name": "tour_deposit",
                  "config": "adaptive cvrp500, the improved iteration-best route", **k8,
                  "tolerance": "as phase 9"})
            out.update(k7c=k7c, k8=k8)
    mean = lambda runs, t: sum(r["curve"][t] for r in runs) / len(runs)
    out["adaptive_cost"] = [mean(adaptive, t - 1) for t in T_VALUES]
    out["elitist_cost"] = [mean(elitist, t - 1) for t in T_VALUES]
    checks.update(
        adaptive_within_1_05_of_elitist=out["adaptive_cost"][-1] <= 1.05 * out["elitist_cost"][-1],
        adaptive_valid=all(r["valid"] and r["cost_is_route_cost"] for r in adaptive),
        adaptive_pool=all(1 <= r["elite_pool"] <= 5 for r in adaptive),
        adaptive_launches=all(r["launches_ok"] for r in adaptive),
        elitist_launches=all(only(r["launches"], {"cvrp_construct": t_max,
                                                  "tour_deposit": t_max}) for r in elitist),
        adaptive_k7c=out["k7c"]["passed"], adaptive_k8=out["k8"]["passed"])

    # (c) the sparse-support runner at the main path's inputs
    dist = distance_matrix(coords)
    nbr = topk_smallest(dist, K)[1]
    cfg = ACOConfig(n_ants=A)

    def sparse_run(ops, t=t_max):
        stats = {}
        zero()
        t0 = time.perf_counter()
        heu = ops.heuristic(net, coords, dist, K)
        curve = bt.run_anytime_sparse(heu, dist, nbr, cfg, torch.Generator(device=dev).manual_seed(
            SEED), t, stats=stats, _ops=ops)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        best = stats.pop("best")
        ident = torch.arange(N, device=dev).expand_as(best)
        return {"cost": [curve[:, t_ - 1].mean().item() for t_ in T_VALUES if t_ <= t],
                "wall_s": wall, "launches": counts(), **stats,
                "fallback_share": stats["fallback_steps"] / stats["steps"],
                "sync_share_of_wall": stats["sync_s"] / wall,
                "permutations": int((torch.sort(best, dim=-1).values == ident).all(-1).sum()),
                "monotone": bool((curve[:, 1:] <= curve[:, :-1]).all())}, heu

    sparse_run(bt.KERNEL_OPS, 1)                       # first touch
    sk, heu = sparse_run(bt.KERNEL_OPS)
    sp, _ = sparse_run(bt.PLAIN_OPS)
    sk["device_t1_under_profiler"] = device_busy(lambda: sparse_run(bt.KERNEL_OPS, 1))
    out["sparse"] = {"kernel": sk, "plain": sp, "main_path_wall_s": main_wall}
    checks.update(
        sparse_launches=only(sk["launches"], {"tsp_dense_heuristic": 1,
                                              "fused_tsp_update": t_max}),
        sparse_plain_launches=only(sp["launches"], {}),
        sparse_t1_vs_plain=abs(sk["cost"][0] - sp["cost"][0]) <= 1e-4 * sp["cost"][0],
        sparse_t10_vs_plain=abs(sk["cost"][-1] - sp["cost"][-1]) <= 0.01 * sp["cost"][-1],
        sparse_t10_vs_main=abs(sk["cost"][-1] - RECORDED_COSTS["main"][1])
        <= 0.02 * RECORDED_COSTS["main"][1],
        sparse_permutations=all(r["permutations"] == B and r["monotone"] for r in (sk, sp)))
    # K3 with the f32 score on the runner's first iteration: the sweep's
    # tours from uniform starts on a pheromone of ones
    log_heu = torch.log(torch.clamp(heu, min=1e-30))
    state = bt._batched_init(B, N, cfg, dev)
    score = bt.next_score(state.phe.tau, log_heu, 1.0, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.randint(0, N, (B, A), generator=gen, device=dev)
    tours = bt.sweep_construct(score, torch.gather(score, -1, nbr), nbr, start, gen)
    kw = {"decay": 0.9, "q": 1.0, "log_heu": log_heu, "score_dtype": torch.float32}
    got, costs_k, score_k = bt.fused_tsp_update(state, tours, dist, **kw)
    ref, costs_p, _ = bt.fused_tsp_update_plain(state, tours, dist, **kw)
    own = track_best(state, tours, costs_k)
    k3_ok = bool(torch.allclose(got.phe.tau, ref.phe.tau, rtol=1e-6, atol=0)
                 and torch.allclose(costs_k, costs_p, rtol=1e-6, atol=0)
                 and torch.equal(got.best_cost, own.best_cost)
                 and torch.equal(got.best_path, own.best_path)
                 and torch.equal(score_k, bt.next_score(got.phe.tau, log_heu, 1.0,
                                                        torch.float32)))
    out["k3_f32"] = {"passed": k3_ok,
                     "max_abs_err": max((got.phe.tau - ref.phe.tau).abs().max().item(),
                                        (costs_k - costs_p).abs().max().item()),
                     "ms": cuda_ms(lambda: bt.fused_tsp_update(state, tours, dist, **kw), 20),
                     "plain_ms": cuda_ms(lambda: bt.fused_tsp_update_plain(state, tours, dist,
                                                                            **kw), 5),
                     **dict(zip(("bound_ms", "bound_by"), bound(*k3_work(B, N, A, 4))))}
    emit({"phase": "kernel", "name": "fused_tsp_update", "config": "sparse runner, f32 score",
          **out["k3_f32"], "tolerance": "as phase 2, the f32 score bit-equal to next_score of "
                                        "the kernel's own tau'"})
    checks["sparse_k3_f32"] = k3_ok
    del dist, nbr, heu, log_heu, state, score, tours, got, ref, own, score_k

    # (d) the MKP-items single-instance step at its envelope
    family, tcfg, tstate, rng, gen = family_train_inputs(dev, "mkp_items")
    inst = family.gen(rng, tcfg.n_nodes)
    prize = torch.as_tensor(inst["prize"], device=dev)
    weight = torch.as_tensor(inst["weight"], device=dev)
    net_k = tstate.net
    net_p, net_s = copy.deepcopy(net_k), copy.deepcopy(net_k)
    before = copy.deepcopy(net_k.state_dict())
    zero()
    one = {"prize": prize[None], "weight": weight[None]}
    out_k = drivers.family_loss(family, net_k, one, tcfg, gen)
    out_k.loss.backward()
    arm_launches = counts()
    out_p = drivers.family_loss(family, net_p, one, tcfg, gen, paths=out_k.paths,
                                _ops=drivers.PLAIN_OPS)
    out_p.loss.backward()
    agreement = step_agreement(tcfg, net_k, net_p, before, out_k, out_p,
                               -(out_k.costs - out_k.costs.mean(dim=-1, keepdim=True)))
    step = special.make_mkp_items_train_step(tcfg)
    zero()
    t0 = time.perf_counter()
    s_state, mon = step(tr.TrainState(net_s, tr.make_optimizer(net_s, tcfg), 0, False),
                        inst["prize"], inst["weight"], gen)
    mon = mon.item()
    step_wall = time.perf_counter() - t0
    step_launches = counts()
    k7r_step = {"fused_rollout": 1, "fused_rollout_backward": 1}
    out["items_step"] = {"N": tcfg.n_nodes, "A": tcfg.aco.n_ants, "agreement": agreement,
                         "arm_launches": arm_launches, "step_launches": step_launches,
                         "step_wall_s": step_wall, "mean_objective": mon}
    checks.update(items_step_agreement=agreement["passed"],
                  items_step_launches=(only(arm_launches, k7r_step)
                                       and only(step_launches, k7r_step)),
                  items_step_ran=s_state.step == 1 and math.isfinite(mon))

    emit({"phase": "remaining_paths", "reference_pt": cli_arms, "launches_expected": cli_want,
          "npz_arrays": out["npz_arrays"], "adaptive": adaptive, "elitist": elitist,
          "adaptive_cost": out["adaptive_cost"], "elitist_cost": out["elitist_cost"],
          "sparse": out["sparse"], "items_step": out["items_step"], "checks": checks})
    out.update(cli=cli_arms, adaptive=adaptive, elitist=elitist)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase 20: the multi-GPU paths (parallel/): the main path's first PAR_B
# instances for the sharded train step, the sparse path's first TSP2000
# instance for the row-sharded forward, bench.py's anchor shape for its
# edges/s, the island search's rounds
PAR_B, PAR_STEPS = 4, 2
PAR_ROUNDS, PAR_SYNC, PAR_BLEND = 5, 2, 0.25
BENCH_N, BENCH_K = 2048, 32


def parallel_train_config():
    """The sharded step's envelope: TSP500's (``train_configs``) at 20 ants
    and ``PAR_B`` instances a step."""
    from deepaco_tpu_torch.train.config import ACOSettings, ProblemConfig, TrainConfig

    return ProblemConfig(
        n_nodes=N, k_sparse=K, aco=ACOSettings(n_ants=A),
        train=TrainConfig(lr=3e-4, weight_decay=1e-2, grad_clip=3.0, epochs=5,
                          steps_per_epoch=128, batch_size=PAR_B, cosine_schedule=False,
                          seed=SEED))


def check_layer_rows(cuda_ms, emb, g, rows: slice) -> dict:
    """K6's forward on a row shard (``fused_gnn_layer_rows``: the shard's
    rows of x3, nbr and w against the instance's whole x2 and x4) on the
    first layer's real inputs of one instance, against its plain version
    (phase 6's tolerances: rtol 1e-5, atol 1e-5); with ``cuda_ms`` its
    times and bound."""
    import torch
    from torch.nn import functional as F

    from deepaco_tpu_torch.ops import gnn_layer

    _, n, k = g.nbr.shape
    u = emb.units
    with torch.no_grad():
        x = F.silu(emb.v_lin0(g.x))
        w = F.silu(emb.e_lin0(g.edge[:, rows]))
        lin = emb.e_lins0[0]
        args = (emb.v_lins2[0](x), emb.v_lins3[0](x)[:, rows], emb.v_lins4[0](x),
                g.nbr[:, rows], w, lin.weight.T, lin.bias)
        got = gnn_layer.fused_gnn_layer_rows(*args)
        want = gnn_layer.fused_gnn_layer_plain(*args)
        ok = all(bool(torch.allclose(a, r, rtol=1e-5, atol=1e-5)) for a, r in zip(got, want))
        out = {"R": w.shape[1], "N": n, "K": k, "passed": ok,
               "max_abs_err": max((a - r).abs().max().item() for a, r in zip(got, want))}
        if cuda_ms is not None:
            out.update(
                ms=cuda_ms(lambda: gnn_layer.fused_gnn_layer_rows(*args), 5),
                plain_ms=cuda_ms(lambda: gnn_layer.fused_gnn_layer_plain(*args), 2),
                library_ms=None,
                **dict(zip(("bound_ms", "bound_by"),
                           bound(*k6_forward_work(1, w.shape[1], n, k, u)))))
    return out


def parallel_checks(dev, root: Path, mesh, net, coords, heu0, cuda_ms=None) -> dict:
    """The multi-GPU paths on ``mesh`` (one rank's share), each run with the
    kernels' counts set to 0 just before it and read just after:

    (a) ``sharded_embnet_forward`` on the sparse path's first TSP2000
        instance (k = 200, ``tsp500_selftrained``'s ``emb_net``) in eval and
        train mode, against the unsharded ``EmbNet`` with the plain layer
        (within 1e-4 of the largest entry), one K6 launch a layer, the
        running statistics untouched; K6 on a row shard (R = N/4, and this
        rank's R = N/D) against its plain version; with ``cuda_ms``
        ``edges_per_second_bench`` there and at bench.py's anchor shape;
    (b) ``make_sharded_tsp_train_step`` at TSP500 (the main path's first
        PAR_B instances, 20 ants): one step on replayed tours (sampled once
        on the starting weights) against the unsharded step (``tsp_loss`` +
        backward + ``optimizer_update``) from the same weights: loss and
        gradient norm rtol 1e-5, every gradient within 1e-5 of the whole
        gradient's largest entry, running statistics rtol 1e-5, the updated
        weights bit-equal on every rank; then PAR_STEPS
        sampled steps, 12 + 12 K6 and N-1 K7 launches each;
    (c) ``evaluate_family("cvrp", mesh=)`` on the golden CVRP500 set (A=20,
        T=1 and 10): this rank's block equal to the block run alone with its
        ``block_seed``, every best route valid, launches K9 1, K7c 10, K8 10;
    (d) ``multi_colony_tsp_search`` on the main path's first instance with
        K1's heuristic ``heu0`` (20 ants, PAR_ROUNDS rounds of PAR_SYNC,
        ``migrate_weight=1``, ``blend=PAR_BLEND``): a monotone curve, the same
        on every rank; with migration and blend off, each round's cost the
        best of the colonies run alone with ``colony_seed``.
    Returns the checks, costs, launches and kernel fields."""
    import copy

    import torch
    import torch.distributed as dist

    from deepaco_tpu_torch.aco.engine import rollout
    from deepaco_tpu_torch.aco.problems.cvrp import route_cost
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix, tour_cost, tsp_spec
    from deepaco_tpu_torch.aco.runner import ACOConfig, init_search, run_anytime
    from deepaco_tpu_torch.core.graph import knn_graph
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.aco.engine import gumbel
    from deepaco_tpu_torch.ops import deposit, fused_gnn, gnn_layer, pick
    from deepaco_tpu_torch.ops import rollout as rollout_ops
    from deepaco_tpu_torch.parallel import (edges_per_second_bench, make_sharded_tsp_train_step,
                                            sharded_embnet_forward)
    from deepaco_tpu_torch.parallel._axes import block_seed, instance_block
    from deepaco_tpu_torch.parallel.mesh import colony_seed, multi_colony_tsp_search
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.train.reinforce import (TrainState, make_optimizer,
                                                   optimizer_update, tsp_heuristic, tsp_loss)
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    counted = (gnn_layer.fused_gnn_layer_rows, gnn_layer.fused_gnn_layer,
               gnn_layer.fused_gnn_layer_backward, pick.fused_pick, rollout_ops.fused_rollout,
               rollout_ops.fused_rollout_backward, rollout_ops.fused_rollout_paths,
               deposit.tour_deposit, cc.cvrp_construct, fused_gnn.embnet_layers)

    def zero():
        torch.cuda.synchronize()
        for fn in counted:
            fn.launches = 0

    def read():
        torch.cuda.synchronize()
        return {fn.__name__: fn.launches for fn in counted}

    def same_on_every_rank(t: torch.Tensor) -> bool:
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, t.contiguous())
        return all(torch.equal(p, parts[0]) for p in parts)

    checks, out = {}, {}
    block = instance_block(mesh)
    # ---- (a) the row-sharded forward
    snet, sg = sparse_inputs(root, dev)
    emb = snet.emb_net.eval()
    g1 = sg._replace(x=sg.x[:1], nbr=sg.nbr[:1], edge=sg.edge[:1])
    del sg
    n_s = g1.nbr.shape[1]
    before = {k: v.clone() for k, v in emb.state_dict().items()}
    fwd = {}
    for train in (False, True):
        zero()
        t0 = time.perf_counter()
        got = sharded_embnet_forward(emb, g1.x[0], g1.nbr[0], g1.edge[0], mesh, train=train)
        launches = read()
        wall = time.perf_counter() - t0
        with torch.no_grad():
            want = copy.deepcopy(emb).train(train)(g1, gnn_layer.fused_gnn_layer_plain)[0]
        err = norm_err(got, want)
        fwd["train" if train else "eval"] = {"norm_err": err, "wall_s": wall,
                                             "launches": launches["fused_gnn_layer_rows"]}
        checks[f"forward_{'train' if train else 'eval'}"] = (
            err <= 1e-4 and launches["fused_gnn_layer_rows"] == emb.depth
            and sum(launches.values()) == emb.depth)
    checks["forward_statistics_untouched"] = all(
        torch.equal(v, emb.state_dict()[k]) for k, v in before.items())
    shard = slice(block.index * n_s // block.count, (block.index + 1) * n_s // block.count)
    layer_quarter = check_layer_rows(cuda_ms, emb, g1, slice(0, n_s // 4))
    layer_own = check_layer_rows(None, emb, g1, shard)
    checks["k6_rows"] = layer_quarter["passed"] and layer_own["passed"]
    if cuda_ms is not None:
        fwd["edges_per_s"] = edges_per_second_bench(emb, g1.x[0], g1.nbr[0], g1.edge[0], mesh)
        c_b = uniform_coords(BENCH_N, torch.Generator().manual_seed(SEED), batch=1, device=dev)
        gb = knn_graph(c_b, distance_matrix(c_b), BENCH_K)
        fwd["edges_per_s_bench_shape"] = edges_per_second_bench(emb, gb.x[0], gb.nbr[0],
                                                                gb.edge[0], mesh)
    del g1, snet
    out.update(forward=fwd, k6_rows=layer_quarter, k6_rows_own={
        k: layer_own[k] for k in ("R", "N", "K", "passed", "max_abs_err")})

    # ---- (b) the sharded train step at TSP500
    cfg = parallel_train_config()
    n_inst = mesh.size(0)
    ant_index, n_ant = mesh.get_local_rank(1), mesh.size(1)
    a_local = A // n_ant
    c4 = coords[:PAR_B]
    rows = block.rows(PAR_B)
    ants = slice(ant_index * a_local, (ant_index + 1) * a_local)
    w0 = copy.deepcopy(net)
    with torch.no_grad():
        heu_s, _ = tsp_heuristic(copy.deepcopy(w0), c4, k_sparse=K, eps=cfg.train.eps,
                                 train=True)
        gen = torch.Generator(device=dev).manual_seed(SEED + 21)
        replay = rollout(tsp_spec(torch.ones_like(heu_s), heu_s, A), gen).paths

    def arm(sharded: bool):
        net_a = copy.deepcopy(w0)
        state = TrainState(net_a, make_optimizer(net_a, cfg), 0, False)
        grads = {}
        state.optimizer.register_step_pre_hook(lambda opt, *_: grads.update(
            {n: p.grad.clone() for n, p in net_a.named_parameters()}))
        if sharded:
            step = make_sharded_tsp_train_step(net_a, cfg, mesh)
            state, info = step(state, c4[rows], torch.Generator(device=dev),
                               paths=replay[rows][..., ants])
            loss, norm = info.loss.item(), info.grad_norm.item()
        else:
            lo = tsp_loss(net_a, c4, cfg, torch.Generator(device=dev), paths=replay)
            lo.loss.backward()
            state, norm_t = optimizer_update(state, cfg)
            loss, norm = lo.loss.item(), norm_t.item()
        return {"loss": loss, "norm": norm, "grads": grads, "net": net_a, "state": state}

    s_arm, u_arm = arm(True), arm(False)
    scale = max(g.abs().max().item() for g in u_arm["grads"].values())
    grad_err = max(((s_arm["grads"][k] - g).abs() - 1e-5 * g.abs()).max().item() / scale
                   for k, g in u_arm["grads"].items())
    stats_ok = all(torch.allclose(a, b, rtol=1e-5, atol=1e-7) for a, b in zip(
        s_arm["net"].buffers(), u_arm["net"].buffers()))
    # reported, not held: AdamW's first update moves a weight by about lr
    # times the sign of its gradient, so the rounding noise of a zero
    # gradient (the biases ahead of a BatchNorm) flips it
    weights_diff = max((a - b).abs().max().item() for a, b in zip(
        s_arm["net"].parameters(), u_arm["net"].parameters()))
    flat = torch.cat([p.detach().reshape(-1) for p in s_arm["net"].parameters()]
                     + [b.reshape(-1) for b in s_arm["net"].buffers()])
    agreement = {
        "loss": [s_arm["loss"], u_arm["loss"]], "grad_norm": [s_arm["norm"], u_arm["norm"]],
        "grad_err_over_largest": grad_err, "statistics_close": stats_ok,
        "weights_max_abs_diff": weights_diff,
        "weights_equal_on_every_rank": same_on_every_rank(flat)}
    checks["train_step_agreement"] = (
        abs(s_arm["loss"] - u_arm["loss"]) <= 1e-5 * abs(u_arm["loss"])
        and abs(s_arm["norm"] - u_arm["norm"]) <= 1e-5 * u_arm["norm"]
        and grad_err <= 1e-5 and stats_ok
        and agreement["weights_equal_on_every_rank"])
    state = s_arm["state"]
    step = make_sharded_tsp_train_step(state.net, cfg, mesh)
    gen = torch.Generator(device=dev).manual_seed(block_seed(SEED, dist.get_rank()))
    steps = []
    for _ in range(PAR_STEPS):
        zero()
        t0 = time.perf_counter()
        state, info = step(state, c4[rows], gen)
        launches = read()
        steps.append({"loss": info.loss.item(), "mean_cost": info.mean_cost.item(),
                      "grad_norm": info.grad_norm.item(),
                      "wall_s": time.perf_counter() - t0, "launches": launches})
    want = {"fused_gnn_layer": 12, "fused_gnn_layer_backward": 12, "fused_pick": 0,
            "fused_rollout": 1, "fused_rollout_backward": 1}
    checks["train_steps"] = all(
        all(s["launches"][k] == v for k, v in want.items())
        and math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"]) for s in steps)
    flat = torch.cat([p.detach().reshape(-1) for p in state.net.parameters()])
    checks["train_steps_weights_equal_on_every_rank"] = same_on_every_rank(flat)
    # K7r at the sharded step's rollout: its instances and starts on the heuristic
    k7r = None
    if cuda_ms is not None:
        with torch.no_grad():
            h = heu_s[rows]
            start = replay[rows][:, 0, ants]
            score = score_matrix(torch.ones_like(h), h, 1.0, 1.0)
            noise = gumbel((N - 1, *start.shape, N), gen, dev)
        k7r = check_rollout(cuda_ms, score, start, noise, rollout_ops.TSP_SHAPE,
                            f"sharded tsp{N} train step, one rank's rollout")
        checks["k7r_step_rollout"] = k7r["passed"]
        del score, noise
    out.update(train_agreement=agreement, train_steps=steps, k7r=k7r)
    del w0, s_arm, u_arm, state, heu_s

    # ---- (c) evaluate_family("cvrp", mesh=)
    cnet, ds = family_inputs(root, dev, "cvrp")
    zero()
    t0 = time.perf_counter()
    means, curves = drivers.evaluate_family("cvrp", ds, n_nodes=CVRP_N, net=cnet, n_ants=A,
                                            t_values=T_VALUES, seed=SEED, device=dev,
                                            mesh=mesh)
    launches = read()
    wall = time.perf_counter() - t0
    b_cv = len(next(iter(ds.values())))
    cv_rows = block.rows(b_cv)
    alone_means, alone, alone_state = drivers.evaluate_family(
        "cvrp", {k: v[cv_rows] for k, v in ds.items()}, n_nodes=CVRP_N, net=cnet, n_ants=A,
        t_values=T_VALUES, seed=block_seed(SEED, block.index), device=dev,
        return_state=True)
    inst = drivers.instance_tensors({k: v[cv_rows] for k, v in ds.items()}, dev)
    best = alone_state.best_path[..., None]
    valid = valid_solutions("cvrp", best, inst)[:, 0]
    recost = route_cost(inst["dist"], best)[:, 0]
    cv_want = {"embnet_layers": 1, "cvrp_construct": max(T_VALUES),
               "tour_deposit": max(T_VALUES), "fused_pick": 0, "fused_gnn_layer": 0}
    checks["cvrp_mesh_equals_block_alone"] = bool(torch.equal(curves[cv_rows], alone))
    checks["cvrp_mesh_routes"] = bool(valid.all()) and bool(
        torch.allclose(recost, alone[:, -1], rtol=1e-5))
    checks["cvrp_mesh_launches"] = all(launches[k] == v for k, v in cv_want.items())
    out["cvrp"] = {"B": b_cv, "cost": means.tolist(), "wall_s": wall, "launches": launches}
    del cnet, ds, curves, alone, alone_state, inst

    # ---- (d) the island search on the main path's first instance
    icfg = ACOConfig(n_ants=A)
    d0 = distance_matrix(coords[:1])[0]
    zero()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    curve = multi_colony_tsp_search(mesh, heu0, d0, icfg, SEED, n_rounds=PAR_ROUNDS,
                                    sync_every=PAR_SYNC, migrate_weight=1.0, blend=PAR_BLEND,
                                    device=dev)
    launches = read()
    wall = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    curve0 = multi_colony_tsp_search(mesh, heu0, d0, icfg, SEED, n_rounds=PAR_ROUNDS,
                                     sync_every=PAR_SYNC, migrate_weight=0.0, blend=0.0,
                                     device=dev)
    colonies = []
    for c in range(mesh.size(0)):
        gen = torch.Generator(device=dev).manual_seed(colony_seed(SEED, c))
        colony_state, alone = run_anytime(
            lambda tau, g: rollout(tsp_spec(tau, heu0[None], A, None), g).paths,
            lambda p: tour_cost(d0[None], p), icfg,
            init_search(N, N - 1, icfg, batch=(1,), device=dev), gen, PAR_ROUNDS * PAR_SYNC)
        colonies.append(alone[0])
    ends = [(r + 1) * PAR_SYNC - 1 for r in range(PAR_ROUNDS)]
    best_alone = torch.stack(colonies).min(dim=0).values[ends]
    # an iteration: one K7r untraced launch, one update; a migration a round
    i_want = {"fused_pick": 0, "fused_rollout_paths": PAR_ROUNDS * PAR_SYNC,
              "tour_deposit": PAR_ROUNDS * PAR_SYNC + PAR_ROUNDS}
    checks["island_monotone"] = bool((curve[1:] <= curve[:-1]).all()) and bool(
        torch.isfinite(curve).all()) and same_on_every_rank(curve)
    checks["island_without_migration_equals_colonies_alone"] = bool(
        torch.equal(curve0, best_alone))
    checks["island_launches"] = all(launches[k] == v for k, v in i_want.items())
    out["island"] = {"curve": curve.tolist(), "curve_without_migration": curve0.tolist(),
                     "cost": [curve[0].item(), curve[-1].item()], "wall_s": wall,
                     "peak_gb": peak_gb, "launches": launches, "colonies": mesh.size(0)}
    if cuda_ms is not None:
        # K8 at the migration's shape: one colony's best tour, one ant
        best = colony_state.best_path[:, :, None]
        out["k8"] = deposit_case(dev, cuda_ms, best, 1.0 / colony_state.best_cost[:, None], N,
                                 cyclic=True)
        checks["k8_migration"] = out["k8"]["passed"]
    out["checks"] = checks
    return out


def _parallel_rank(rank: int, world: int, root: str, store: str) -> None:
    """One rank of the multi-card run of ``parallel_checks`` (one a card,
    spawned by ``parallel_phase``): its results go to a JSON file a rank."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, root)
    from deepaco_tpu_torch.ops import fused_gnn
    from deepaco_tpu_torch.parallel import make_mesh
    from deepaco_tpu_torch.parallel.multihost import init_distributed
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_distributed(f"file://{store}", world, rank)
    try:
        mesh = make_mesh(2, world // 2) if world % 2 == 0 else make_mesh(world, 1)
        net, coords = main_path_inputs(Path(root), dev)
        heu0 = fused_gnn.tsp_dense_heuristic(net, coords[:1], distance_matrix(coords[:1]), K)[0]
        res = parallel_checks(dev, Path(root), mesh, net, coords, heu0)
        res = {"mesh": list(mesh.shape), "checks": res["checks"],
               "forward": res["forward"], "train_agreement": res["train_agreement"],
               "cvrp": res["cvrp"], "island": res["island"]}
    finally:
        dist.destroy_process_group()
    (Path(store).parent / f"rank{rank}.json").write_text(json.dumps(res))


def parallel_phase(dev, root: Path, cuda_ms, net, coords) -> dict:
    """Phase 20, the multi-GPU paths (``parallel/``). NCCL refuses two ranks
    on one card, so on one card they run at world size 1: a one-rank NCCL
    group (``init_distributed(num_processes=1)``, every collective a real
    NCCL call) and a 1 x 1 mesh, through ``parallel_checks`` with the
    kernels' times; with two cards or more, one rank a card is spawned as
    well (a 2 x D/2 mesh) and runs the same checks without the timings.
    The group is destroyed at the end and the current card is left as it
    was. Emits one line and returns what the kernels' line and the checks
    read."""
    import tempfile

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from deepaco_tpu_torch.ops import fused_gnn
    from deepaco_tpu_torch.parallel import make_mesh
    from deepaco_tpu_torch.parallel.multihost import init_distributed
    from deepaco_tpu_torch.utils.datasets import distance_matrix

    cards = torch.cuda.device_count()
    worlds = [1] + ([cards] if cards >= 2 else [])
    emit({"phase": "parallel_worlds", "world_sizes": worlds, "cards": cards,
          "why": "world size 1 on every machine (a one-rank NCCL group: NCCL refuses two "
                 "ranks on one card)" + (f"; {cards}, one rank a card" if cards >= 2 else
                                         "; one card, so no multi-rank run")})
    current = torch.cuda.current_device()
    heu0 = fused_gnn.tsp_dense_heuristic(net, coords[:1], distance_matrix(coords[:1]), K)[0]
    t0 = time.perf_counter()
    init_distributed(num_processes=1)
    try:
        res = parallel_checks(dev, root, make_mesh(1, 1), net, coords, heu0, cuda_ms)
    finally:
        dist.destroy_process_group()
        torch.cuda.set_device(current)
    res["wall_s"] = time.perf_counter() - t0
    res["world_sizes"] = worlds
    if cards >= 2:
        out_dir = Path(tempfile.mkdtemp(dir=root / "build"))
        t0 = time.perf_counter()
        mp.spawn(_parallel_rank, args=(cards, str(root), str(out_dir / "store")),
                 nprocs=cards, join=True)
        ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(cards)]
        shutil.rmtree(out_dir, ignore_errors=True)
        res["multi"] = {"world": cards, "wall_s": time.perf_counter() - t0, "ranks": ranks}
        for r, rr in enumerate(ranks):
            res["checks"].update({f"world{cards}_rank{r}_{k}": v
                                  for k, v in rr["checks"].items()})
    emit({"phase": "parallel", **{k: v for k, v in res.items() if k not in ("k7r", "k8")},
          "card": card_line(),
          "tolerance": "the sharded forward within 1e-4 of the largest entry of the "
                       "unsharded plain EmbNet; K6 on a row shard rtol 1e-5, atol 1e-5; the "
                       "sharded step against the unsharded one: loss and gradient norm rtol "
                       "1e-5, gradients within 1e-5 of the largest entry, statistics rtol "
                       "1e-5, weights bit-equal on every rank; evaluate_family(mesh=) and the island search "
                       "without migration equal to their blocks and colonies alone"})
    return res


def family_kernel_fields(r: dict) -> dict:
    """A phase-14 family's fields of K6, K7, K7r, K7c, K8 and K9 in the
    kernels' line, from ``family_phase``'s result: the launches on its
    kernel arm (K7, K7c or K7r's untraced forward, K8, K9) and in its
    training steps (K6, K7, K7r), and the error, times and bound at its
    shapes (K7r's at its training rollout and, untraced, at its inference
    rollout); K7 launches on none of these paths."""
    take = lambda d, keys: {k: d[k] for k in keys if k in d}
    timing = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    launches = r["arms"]["kernel"]["launches"]
    train = {"train_steps": FAMILY_TRAIN_STEPS}
    fields = {"fused_pick": {"launches": launches["fused_pick"],
                             "train_launches": r["train_launches"]["fused_pick"], **train}}
    for name, entry in rollout_entries(r["rollout_train"]).items():
        fields[name] = {"train_launches": r["train_launches"][name], **train, **entry}
    if "k7c" in r:
        fields["cvrp_construct"] = {"launches": launches["cvrp_construct"],
                                    **take(r["k7c"], timing)}
    if "k7r_paths" in r:
        fields["fused_rollout_paths"] = {
            "launches": launches["fused_rollout_paths"],
            **take(r["k7r_paths"], ("config", "B", "N", "A", "T", "ant_steps", "device_ms",
                                    "traced_ms", "peak_gb") + timing)}
    if "k8" in r:
        fields["tour_deposit"] = {"launches": launches["tour_deposit"],
                                  **take(r["k8"], ("B", "L", "A", "n") + timing)}
    if "k9" in r:
        fields["embnet_layers"] = {"launches": launches["embnet_layers"],
                                   **take(r["k9"], timing)}
    if r["layer"] is not None:
        fields["fused_gnn_layer"] = {"train_launches": r["train_launches"]["fused_gnn_layer"],
                                     **train, **take(r["layer"], ("B", "N", "K") + timing)}
        fields["fused_gnn_layer_backward"] = {
            "train_launches": r["train_launches"]["fused_gnn_layer_backward"], **train,
            **take(r["layer"]["backward"], timing)}
    return fields


def main() -> int:
    import copy

    import torch

    if sys.argv[1:] not in ([], ["--parallel-only"]):
        print("usage: chip_smoke.py [--parallel-only]", file=sys.stderr)
        return 2
    parallel_only = sys.argv[1:] == ["--parallel-only"]
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    from deepaco_tpu_torch.aco import batched_tsp as bt
    from deepaco_tpu_torch.aco.problems.tsp import tour_cost
    from deepaco_tpu_torch.aco.runner import ACOConfig, track_best
    from deepaco_tpu_torch.core.builders import cvrp_graph, start_node_features
    from deepaco_tpu_torch.core.graph import topk_smallest
    from deepaco_tpu_torch.eval.anytime import evaluate_tsp
    from deepaco_tpu_torch.models.gnn import Net, init_like_flax
    from deepaco_tpu_torch.aco.problems.cvrp import route_cost, validate_routes
    from deepaco_tpu_torch.aco.problems.tsp import score_matrix
    from deepaco_tpu_torch.families import CVRP_CAPACITY
    from deepaco_tpu_torch.ops import _build, deposit, fused_gnn, gnn_layer, pick, two_opt
    from deepaco_tpu_torch.ops import cvrp_construct as cc
    from deepaco_tpu_torch.ops import rollout as rollout_ops
    from deepaco_tpu_torch.train import drivers
    from deepaco_tpu_torch.train import reinforce as tr
    from deepaco_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from deepaco_tpu_torch.utils.datasets import distance_matrix, uniform_coords

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    # ---- 1. build
    built = _build.build()
    _build.library()
    emit({"phase": "build", "card": card, "nvcc_seconds": built["seconds"],
          "library": str(_build.LIB_PATH.relative_to(root))})
    print(built["log"], file=sys.stderr)

    def cuda_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def timed(fn):
        """One run of ``fn`` between CUDA events: (result, ms)."""
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    net, coords = main_path_inputs(root, dev)
    if parallel_only:
        par = parallel_phase(dev, root, cuda_ms, net, coords)
        if not all(par["checks"].values()):
            fail(f"parallel: {par['checks']}")
        for path, got in (("cvrp", par["cvrp"]["cost"]), ("island", par["island"]["cost"])):
            if any(want is not None and round(c, 4) != want
                   for c, want in zip(got, RECORDED_COSTS[path])):
                fail(f"parallel {path} cost {got} differs from the recorded "
                     f"{RECORDED_COSTS[path]}")
        return finish()

    # ---- 2. K1-K3 against their plain versions, at the main path's shapes
    dist = distance_matrix(coords)
    kernels = []

    heu = fused_gnn.tsp_dense_heuristic(net, coords, dist, K)
    heu_plain = fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, K)
    k1_err = (heu - heu_plain).abs().max().item()
    # The score takes log(heu), so the K on-support entries of each row are
    # also held in log space, where a small sigmoid output counts as much as
    # a large one; the 1e-10 fill off the support matches exactly.
    support = topk_smallest(dist, K)[1]
    on_k, on_p = heu.gather(2, support), heu_plain.gather(2, support)
    k1_log_err = (on_k.log() - on_p.log()).abs().max().item()
    k1_ok = bool(torch.allclose(heu, heu_plain, rtol=1e-4, atol=1e-5)
                 and k1_log_err <= 1e-4)
    feats = coords.shape[-1]
    layers, u = net.emb_net.depth, net.emb_net.units
    # multiply-adds of the node pass and one compare per candidate column
    # for each row's top-K selection; the edge products and the head's two
    # at the tensor cores' 3xTF32 rate
    k1_ops = layers * 2 * B * N * u * 4 * u + B * N * N
    k1_products = layers * 2 * B * N * K * u * u + 4 * B * N * K * u * u
    k1_bytes = 4 * (2 * B * N * N + B * N * feats)
    # the design streams the edge state: the k-NN pass reads dist and writes
    # it, each layer reads and writes it, the head reads it and writes heu
    k1_floor = 4 * (2 * B * N * N + B * N * K * u * (2 + 2 * layers))
    kernels.append({
        "name": "tsp_dense_heuristic", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/dense_heuristic.cu",
        "replaces": "deepaco_tpu/ops/fused_gnn.py:416",
        "max_abs_err": k1_err,
        "ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic(net, coords, dist, K), 5),
        "plain_ms": cuda_ms(lambda: fused_gnn.tsp_dense_heuristic_plain(net, coords, dist, K), 2),
        "library_ms": None, "passed": k1_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k1_bytes, k1_ops, k1_products)))})
    emit({"phase": "kernel", "name": "tsp_dense_heuristic", "passed": k1_ok,
          "max_abs_err": k1_err, "max_log_err_on_support": k1_log_err,
          "support_min": on_p.min().item(),
          "support_median": on_p.median().item(),
          "design_floor_ms": k1_floor / HBM_BYTES_PER_S * 1e3,
          "tolerance": "rtol 1e-4, atol 1e-5; log(heu) on the support "
                       "atol 1e-4 (sum order)"})

    score = torch.log(torch.clamp(heu, min=1e-30)).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    start = torch.randint(0, N, (B, A), generator=gen, device=dev)
    greedy_k = bt.dense_sweep_fused(score, start, gen, stochastic=False)
    greedy_p = bt.dense_sweep(score, start, gen, stochastic=False)
    k2_greedy_ok = bool(torch.equal(greedy_k, greedy_p))
    paths_k = bt.dense_sweep_fused(score, start, gen)
    paths_p = bt.dense_sweep(score, start, gen)
    ident = torch.arange(N, device=dev)[None, :, None]
    perms_ok = bool((torch.sort(paths_k, dim=1).values == ident).all())
    cost_k = tour_cost(dist, paths_k).mean().item()
    cost_p = tour_cost(dist, paths_p).mean().item()
    k2_ok = k2_greedy_ok and perms_ok and abs(cost_k - cost_p) <= 0.02 * cost_p
    # bound counts tour indices at 4 bytes, as many as a city id needs
    k2_ops = 2 * B * A * (N - 1) * N
    k2_bytes = 2 * B * N * N + 4 * B * A + 4 * B * N * A
    kernels.append({
        "name": "dense_sweep_fused", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/sweep.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:522",
        "max_abs_err": (greedy_k - greedy_p).abs().max().item(),
        "ms": cuda_ms(lambda: bt.dense_sweep_fused(score, start, gen), 5),
        "plain_ms": cuda_ms(lambda: bt.dense_sweep(score, start, gen), 1),
        "library_ms": None, "passed": k2_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(k2_bytes, k2_ops)))})
    emit({"phase": "kernel", "name": "dense_sweep_fused", "passed": k2_ok,
          "greedy_equal": k2_greedy_ok, "permutations": perms_ok,
          "mean_cost_kernel": cost_k, "mean_cost_plain": cost_p,
          "tolerance": "greedy exact; stochastic mean cost within 2%"})

    # K3 on an iteration of the main path: K2's tours, tau in [0.5, 1.5),
    # the heuristic's log, a fresh best state (every instance improves)
    tau = 0.5 + torch.rand((B, N, N), generator=gen, device=dev)
    log_heu = torch.log(torch.clamp(heu, min=1e-30))
    state = bt._batched_init(B, N, ACOConfig(n_ants=A), dev)
    state = state._replace(phe=state.phe._replace(tau=tau))
    k3_args = (state, paths_k, dist)
    k3_kw = {"decay": 0.9, "q": 1.0, "log_heu": log_heu}
    got, costs_k, score_k = bt.fused_tsp_update(*k3_args, **k3_kw)
    ref, costs_p, score_p = bt.fused_tsp_update_plain(*k3_args, **k3_kw)
    own = track_best(state, paths_k, costs_k)
    k3_best_ok = bool(torch.equal(got.best_cost, own.best_cost)
                      and torch.equal(got.best_path, own.best_path))
    k3_score_ok = bool(torch.equal(score_k, bt.next_score(got.phe.tau, log_heu, 1.0,
                                                          torch.bfloat16)))
    k3_ok = bool(torch.allclose(got.phe.tau, ref.phe.tau, rtol=1e-6, atol=0)
                 and torch.allclose(costs_k, costs_p, rtol=1e-6, atol=0)
                 and k3_best_ok and k3_score_ok)
    # the unstaged variant (K3 past 19,000 cities) gives the staged one's bits
    un, costs_u, score_u = bt.fused_tsp_update(*k3_args, **k3_kw, staged=False)
    k3_unstaged_ok = bool(torch.equal(un.phe.tau, got.phe.tau) and torch.equal(costs_u, costs_k)
                          and torch.equal(un.best_cost, got.best_cost)
                          and torch.equal(un.best_path, got.best_path)
                          and torch.equal(score_u, score_k))
    del un, costs_u, score_u
    k3_ok = k3_ok and k3_unstaged_ok
    k3_err = max((got.phe.tau - ref.phe.tau).abs().max().item(),
                 (costs_k - costs_p).abs().max().item())
    k3_score_vs_plain = int((score_k != score_p).sum().item())
    del got, ref, score_k, score_p, own
    # library yardstick: one index_put_ of the 2*B*A*N deposits onto decay*tau
    bi = torch.arange(B, device=dev)[:, None, None].expand(B, A, N).reshape(-1)
    uu = paths_k.transpose(1, 2)
    vv = torch.roll(uu, 1, dims=-1)
    amounts = (1.0 / costs_p)[..., None].expand(B, A, N).reshape(-1)
    index = (torch.cat([bi, bi]), torch.cat([uu.reshape(-1), vv.reshape(-1)]),
             torch.cat([vv.reshape(-1), uu.reshape(-1)]))
    values = torch.cat([amounts, amounts])
    decayed = tau * 0.9
    kernels.append({
        "name": "fused_tsp_update", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/as_update.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:401",
        "max_abs_err": k3_err,
        "ms": cuda_ms(lambda: bt.fused_tsp_update(*k3_args, **k3_kw), 20),
        "plain_ms": cuda_ms(lambda: bt.fused_tsp_update_plain(*k3_args, **k3_kw), 5),
        "library_ms": cuda_ms(lambda: decayed.clone().index_put_(
            index, values, accumulate=True), 20),
        "passed": k3_ok,
        **dict(zip(("bound_ms", "bound_by"), bound(*k3_work(B, N, A, 2))))})
    emit({"phase": "kernel", "name": "fused_tsp_update", "passed": k3_ok,
          "max_abs_err": k3_err, "best_state_equal": k3_best_ok,
          "score_equal": k3_score_ok, "score_entries_differing_from_plain": k3_score_vs_plain,
          "unstaged_equal": k3_unstaged_ok,
          "unstaged_ms": cuda_ms(lambda: bt.fused_tsp_update(*k3_args, **k3_kw, staged=False), 20),
          "tolerance": "tau' and costs at rtol 1e-6; best state and bf16 score bit-equal to "
                       "track_best and next_score of the kernel's own costs and tau'; the "
                       "unstaged variant bit-equal to the staged one"})

    # ---- 3. K4 and K5 against their plain versions
    nls_net, _ = main_path_inputs(root, dev, ls="nls")
    is_perm = lambda t: torch.equal(torch.sort(t, dim=-1).values,
                                    torch.arange(t.shape[-1], device=dev).expand_as(t))

    def ls_case(c, heu, tours, budgets):
        """K4 and K5 on one input; the plain versions count their scans."""
        b, a, n = tours.shape
        hd = two_opt.heuristic_dist(heu)
        budget, t_nls, t_p = budgets
        out = {}
        for name, kern, plain, args, metric_bytes in (
                ("batched_two_opt_euclid", two_opt.batched_two_opt_euclid,
                 two_opt.batched_two_opt_euclid_plain, (c, tours, budget), 0),
                ("batched_nls_euclid", two_opt.batched_nls_euclid,
                 two_opt.batched_nls_euclid_plain,
                 (c, hd, tours, budget, t_nls, t_p), 2 * b * n * n)):
            got = kern(*args)
            scans = {}
            want, plain_ms = timed(lambda: plain(*args, scans=scans))
            ok = bool(torch.equal(got, want) and is_perm(got))
            out[name] = {"passed": ok, "max_abs_err": (got - want).abs().max().item(),
                         "scans": scans, "plain_ms": plain_ms,
                         "ms": cuda_ms(lambda: kern(*args), 3),
                         "bound": ls_bound(n, b, a, scans, metric_bytes)}
            if metric_bytes:   # K5's Euclidean descents alone
                out[name]["ms_t_nls_0"] = cuda_ms(lambda: kern(c, hd, tours, budget, 0, t_p), 3)
            emit({"phase": "kernel", "name": name, "N": n, "B": b, "A": a,
                  "budgets": budgets, "passed": ok, "scans": scans,
                  "ms": out[name]["ms"], "plain_ms": plain_ms,
                  "ms_t_nls_0": out[name].get("ms_t_nls_0"),
                  "bound_ms": out[name]["bound"][0], "bound_by": out[name]["bound"][1],
                  "tolerance": "tours exactly equal, each a permutation"})
        return out

    # the NLS path's own inputs: its B_NLS instances, A ants from city 0
    c_nls = coords[:B_NLS]
    d_nls = distance_matrix(c_nls)
    x_nls = start_node_features(c_nls)
    heu_nls = fused_gnn.tsp_dense_heuristic(nls_net, x_nls, d_nls, K)
    heu_nls_plain = fused_gnn.tsp_dense_heuristic_plain(nls_net, x_nls, d_nls, K)
    k1_nls_ok = bool(torch.allclose(heu_nls, heu_nls_plain, rtol=1e-4, atol=1e-5))
    emit({"phase": "kernel", "name": "tsp_dense_heuristic", "config": "tsp_nls500, one-hot x",
          "B": B_NLS, "passed": k1_nls_ok,
          "max_abs_err": (heu_nls - heu_nls_plain).abs().max().item(),
          "tolerance": "rtol 1e-4, atol 1e-5 (sum order)"})
    if not k1_nls_ok:
        fail("K1 on the NLS configuration disagrees with its plain version")
    score_nls = torch.log(torch.clamp(heu_nls, min=1e-30)).to(torch.bfloat16)
    start_nls = torch.zeros((B_NLS, A), dtype=torch.int64, device=dev)
    sampled = bt.dense_sweep_fused(score_nls, start_nls, gen).transpose(1, 2).contiguous()
    at_500 = ls_case(c_nls, heu_nls, sampled, (LS_BUDGET, 10, 20))
    c_large = uniform_coords(N_LARGE, torch.Generator().manual_seed(SEED + 1),
                             batch=1, device=dev)
    heu_large = fused_gnn.tsp_dense_heuristic(
        nls_net, start_node_features(c_large), distance_matrix(c_large), N_LARGE // 10)
    perms = torch.stack([torch.randperm(N_LARGE, generator=gen, device=dev)
                         for _ in range(2)])[None]
    at_large = ls_case(c_large, heu_large, perms, (50, 1, 5))
    sources = {
        "batched_two_opt_euclid": "deepaco_tpu/ops/pallas_two_opt.py:591 batched_two_opt_euclid; "
                                  "deepaco_tpu/ops/pallas_two_opt.py:535 _tiled_two_opt_call",
        "batched_nls_euclid": "deepaco_tpu/ops/pallas_two_opt.py:631 batched_nls_euclid "
                              "(_nls_kernel:200; _tiled_nls_kernel:476)"}
    for name, replaces in sources.items():
        r = at_500[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "deepaco_tpu_torch/csrc/two_opt.cu", "replaces": replaces,
            "max_abs_err": max(r["max_abs_err"], at_large[name]["max_abs_err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "library_ms": None,
            **({"ms_t_nls_0": r["ms_t_nls_0"]} if "ms_t_nls_0" in r else {}),
            "passed": r["passed"] and at_large[name]["passed"],
            **dict(zip(("bound_ms", "bound_by"), r["bound"]))})

    # ---- 4. the main path at full width
    counted = (fused_gnn.tsp_dense_heuristic, bt.dense_sweep_fused,
               bt.fused_tsp_update, two_opt.batched_two_opt_euclid,
               two_opt.batched_nls_euclid, gnn_layer.fused_gnn_layer,
               gnn_layer.fused_gnn_layer_backward, pick.fused_pick,
               rollout_ops.fused_rollout, rollout_ops.fused_rollout_backward,
               rollout_ops.fused_rollout_paths, deposit.tour_deposit, cc.cvrp_construct,
               fused_gnn.embnet_layers)

    class PhaseTimer:
        """CUDA events around each phase; read after the run has synchronised."""

        def __init__(self):
            self.events = {}

        @contextlib.contextmanager
        def __call__(self, name):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self.events.setdefault(name, []).append((start, end))

        def ms(self):
            return {k: sum(s.elapsed_time(e) for s, e in v)
                    for k, v in self.events.items()}

        def take(self):
            """The phases' ms since the last take, then forget them."""
            out, self.events = self.ms(), {}
            return out

    def run(net_arg, ops=bt.KERNEL_OPS, inputs=coords, ls=None):
        """One call of the path; the kernels' counts are set to 0 just before
        it and read just after."""
        timer = PhaseTimer()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, curves = drive(net_arg, inputs, ops._replace(timer=timer), ls)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (not bool(torch.isfinite(curves).all())
                or curves.shape != (inputs.shape[0], max(T_VALUES))):
            fail(f"bad curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("an anytime curve rose")
        return (means.tolist(), {fn.__name__: fn.launches for fn in counted},
                wall, timer.ms())

    run(net)                                   # first touch of every path
    means, launches, wall, phase_ms = run(net)
    classic, _, classic_wall, _ = run(None)
    plain, _, plain_wall, _ = run(net, bt.PLAIN_OPS)
    tours = B * max(T_VALUES) * A
    emit({"phase": "main_path", "B": B, "N": N, "K": K, "A": A,
          "T": list(T_VALUES), "neural_cost": means, "classic_cost": classic,
          "plain_cost": plain, "wall_s": wall, "tours_per_s": tours / wall,
          "phase_ms": phase_ms, "launches": launches,
          "classic_wall_s": classic_wall, "plain_wall_s": plain_wall})

    # ---- 5. the NLS path: neural + NLS through the kernels and the plain
    # versions, classic + 2-opt through the kernels
    nls_coords = coords[:B_NLS]
    arms = {}
    for arm, net_arg, ls, ops in (("nls", nls_net, "nls", bt.KERNEL_OPS),
                                  ("classic_2opt", None, "2opt", bt.KERNEL_OPS),
                                  ("nls_plain", nls_net, "nls", bt.PLAIN_OPS)):
        cost, counts, arm_wall, arm_ms = run(net_arg, ops, nls_coords, ls)
        arms[arm] = {"cost": cost, "launches": counts, "wall_s": arm_wall,
                     "tours_per_s": B_NLS * max(T_VALUES) * A / arm_wall,
                     "phase_ms": arm_ms}
    emit({"phase": "nls_path", "B": B_NLS, "N": N, "K": K, "A": A,
          "T": list(T_VALUES), "ls_budget": LS_BUDGET, **arms})
    # ---- 6. the training kernels against their plain versions
    row8_ok = check_training_kernels(dev, cuda_ms, kernels)

    # ---- 7. one training step, kernel arm against plain arm; K7r on each
    # step's own rollout
    step_checks, rollout_checks = [], {}
    for name in TRAIN_STEPS:
        captured = []
        step_checks.append(train_step_arms(dev, name, captured))
        emit(step_checks[-1])
        rollout_checks[name] = check_rollout(cuda_ms, *captured[0], f"{name} training rollout")
        del captured
    for name, fields in rollout_entries(rollout_checks["tsp500_nls"]).items():
        kernels.append({
            "name": name, "route": "cuda", "source": "deepaco_tpu_torch/csrc/rollout.cu",
            "replaces": "deepaco_tpu/ops/pallas_kernels.py:65 (fused_pick_pallas, every step of "
                        "the scan deepaco_tpu/aco/engine.py:104-129 with require_prob)",
            "passed": all(r["passed"] for r in rollout_checks.values()), **fields,
            "tsp500": rollout_entries(rollout_checks["tsp500"])[name]})

    # ---- 8. train_tsp in both configurations, then save, reload, evaluate
    def train_run(name):
        """``train_tsp`` on the card (its default device); the kernels'
        counts are set to 0 just before it and read just after."""
        cfg, net_kwargs, ls = train_configs()[name]
        timer, rows = PhaseTimer(), []
        last = [0.0]

        def progress(i, info):
            torch.cuda.synchronize()
            now = time.perf_counter()
            rows.append({"step": i, "loss": info.loss.item(),
                         "mean_cost": info.mean_cost.item(),
                         "grad_norm": info.grad_norm.item(),
                         "wall_ms": (now - last[0]) * 1e3, "phase_ms": timer.take(),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            torch.cuda.reset_peak_memory_stats()
            last[0] = time.perf_counter()

        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        last[0] = time.perf_counter()
        state = tr.train_tsp(Net(**net_kwargs), cfg, local_search=ls, progress=progress,
                             max_steps=TRAIN_STEPS[name],
                             _ops=tr.KERNEL_OPS._replace(timer=timer))
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in counted}
        start = init_like_flax(Net(**net_kwargs).to(dev),
                               torch.Generator(device=dev).manual_seed(cfg.train.seed))
        moved = all(not torch.equal(a, b) for (k, a), b in zip(
            start.state_dict().items(), state.net.state_dict().values())
            if a.dim() == 2 or "running" in k)
        finite = all(math.isfinite(r[key]) for r in rows
                     for key in ("loss", "mean_cost", "grad_norm"))
        # one more step on the trained state under the profiler: the
        # device's busy time, idle share and launches a step
        step_fn = tr.make_tsp_train_step(cfg, ls, _ops=tr.KERNEL_OPS)
        spare, spare_gen = copy.deepcopy(state), torch.Generator(device=dev).manual_seed(SEED + 31)
        profiled = device_busy(lambda: step_fn(spare, spare_gen))
        del spare
        # a step: one K7r launch each way, no K7
        steps = TRAIN_STEPS[name]
        rollout_ok = (counts["fused_rollout"] == steps and counts["fused_rollout_backward"] == steps
                      and counts["fused_pick"] == 0)
        emit({"phase": "train", "config": name, "B": cfg.train.batch_size, "N": N,
              "K": K, "A": cfg.aco.n_ants, "lr": cfg.train.lr,
              "cosine": cfg.train.cosine_schedule, "steps": rows, "launches": counts,
              "profiled_step": profiled, "weights_moved": moved, "finite": finite,
              "rollout_launches_ok": rollout_ok})
        if not (moved and finite and len(rows) == steps and rollout_ok):
            fail(f"training {name}: moved {moved}, finite {finite}, {len(rows)} steps, "
                 f"launches {counts}")
        return state, counts

    train_runs = {name: train_run(name) for name in TRAIN_STEPS}
    nls_state, train_launches = train_runs["tsp500_nls"]
    ckpt = root / "build" / "chip_smoke" / "tsp500_nls_trained.msgpack"
    save_checkpoint(str(ckpt), nls_state)
    tree = load_checkpoint(str(ckpt))
    reloaded = Net.from_jax_variables(tree).to(dev)
    same = all(torch.equal(a, b) for a, b in zip(nls_state.net.state_dict().values(),
                                                   reloaded.state_dict().values()))
    restored = tr.restore_train_state(tree, Net(feats=1).to(dev), train_configs()["tsp500_nls"][0])
    reload_cost, reload_curves = evaluate_tsp(coords[:4], net=reloaded, k_sparse=K,
                                              cfg=ACOConfig(n_ants=A), t_values=(1,),
                                              seed=SEED, ls="nls")
    reload_ok = (same and restored.step == TRAIN_STEPS["tsp500_nls"]
                 and bool(torch.isfinite(reload_curves).all()))
    emit({"phase": "checkpoint", "file": str(ckpt.relative_to(root)),
          "bytes": ckpt.stat().st_size, "weights_equal": same, "step": int(tree["step"]),
          "evaluate_tsp_nls_cost": reload_cost.tolist(), "passed": reload_ok})

    # ---- 9. K8, K7, K7c, K6 and K9 at the CVRP path's shapes
    cvrp_net, cvrp_ds = family_inputs(root, dev, "cvrp")
    cvrp_paths, cvrp_amounts, cvrp_picks = cvrp_rollout(dev, cvrp_ds)
    kernels.append(check_deposit(dev, cuda_ms, paths_k, 1.0 / costs_p, cvrp_paths,
                                 cvrp_amounts))
    pick_501 = check_pick_rows(cuda_ms, cvrp_picks)
    emit({"phase": "kernel", "name": "fused_pick", "config": "cvrp500 rollout, N = 501",
          **pick_501, "tolerance": "actions exact and allowed; logp rtol 1e-5, atol 1e-5 "
                                   "(logsumexp order, expf/logf against torch's)"})
    cvrp_dist = torch.as_tensor(cvrp_ds["dist"], device=dev)
    kernels.append(check_cvrp_construct(
        dev, cuda_ms, score_matrix(torch.ones_like(cvrp_dist), 1.0 / cvrp_dist, 1.0, 1.0),
        torch.as_tensor(cvrp_ds["demand"], device=dev), CVRP_CAPACITY))
    del cvrp_dist
    cvrp_g = cvrp_graph(torch.as_tensor(cvrp_ds["demand"], device=dev),
                        torch.as_tensor(cvrp_ds["dist"], device=dev))
    layer_501 = check_layer(dev, cuda_ms, cvrp_net, cvrp_g)
    emit({"phase": "kernel", "name": "fused_gnn_layer", "config": "cvrp500, K = N = 501",
          **layer_501, "tolerance": "rtol 1e-5, atol 1e-5 (sum order)"})
    k9_501 = check_embnet_layers(cuda_ms, cvrp_net, cvrp_g, "cvrp500, K = N = 501")
    del cvrp_g

    # ---- 10. the CVRP path: kernel, plain and classic arms
    cvrp_dist = torch.as_tensor(cvrp_ds["dist"], device=dev)
    cvrp_demand = torch.as_tensor(cvrp_ds["demand"], device=dev)
    cvrp_b = cvrp_dist.shape[0]

    def cvrp_run(net_arg, ops):
        """One call of the CVRP path; the kernels' counts are set to 0 just
        before it and read just after."""
        timer = PhaseTimer()
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cost, curves, state = drive_family(net_arg, cvrp_ds, ops._replace(timer=timer), "cvrp")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if (not bool(torch.isfinite(curves).all())
                or curves.shape != (cvrp_b, max(T_VALUES))):
            fail(f"bad CVRP curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("a CVRP anytime curve rose")
        best = state.best_path[..., None]
        valid = validate_routes(best, cvrp_demand, CVRP_CAPACITY)[:, 0]
        recost = route_cost(cvrp_dist, best)[:, 0]
        return {"cost": cost.tolist(), "wall_s": wall, "phase_ms": timer.ms(),
                "launches": {fn.__name__: fn.launches for fn in (
                    fused_gnn.embnet_layers, gnn_layer.fused_gnn_layer, pick.fused_pick,
                    deposit.tour_deposit, cc.cvrp_construct)},
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "valid_best_routes": int(valid.sum()),
                "best_cost_is_route_cost": bool(torch.allclose(recost, state.best_cost,
                                                               rtol=1e-5))}

    cvrp_arms = {"kernel": cvrp_run(cvrp_net, drivers.KERNEL_OPS),
                 "plain": cvrp_run(cvrp_net, drivers.PLAIN_OPS),
                 "classic": cvrp_run(None, drivers.KERNEL_OPS)}
    emit({"phase": "cvrp_path", "B": cvrp_b, "N": CVRP_N + 1, "A": A,
          "T": list(T_VALUES), "capacity": CVRP_CAPACITY, **cvrp_arms})

    # ---- 11. CVRP training at the CVRP500 envelope
    import io

    from deepaco_tpu_torch import cli

    # (a) one step, kernel arm against plain arm; K6 and K7r at its shapes
    step_check, train_rollouts, train_batch, train_net = family_train_step_arms(dev, "cvrp")
    layer_train = check_layer(dev, cuda_ms, train_net, cvrp_graph(
        torch.as_tensor(train_batch["demand"], device=dev),
        torch.as_tensor(train_batch["dist"], device=dev)), backward=True)
    emit({"phase": "kernel", "name": "fused_gnn_layer", "config": "cvrp500 training, B=1, "
          "K = N = 501", **layer_train, "tolerance": "forward rtol 1e-5, atol 1e-5 (sum order); "
          "backward rtol 1e-4, atol 1e-5 of the largest entry"})
    rollout_train = check_rollout(cuda_ms, *train_rollouts[0],
                                  f"cvrp{CVRP_N} training rollout, {A_TRAIN} ants")
    del train_net, train_rollouts

    # (b) make_family_train_step: the kernels' counts set to 0 just before
    # each step and read just after
    family, train_cfg, train_state, train_rng, train_gen = family_train_inputs(dev, "cvrp")
    timer = PhaseTimer()
    step_fn = drivers.make_family_train_step(family, train_cfg,
                                             _ops=drivers.KERNEL_OPS._replace(timer=timer))
    start = {k: v.clone() for k, v in train_state.net.state_dict().items()}
    train_rows = []
    for i in range(CVRP_TRAIN_STEPS):
        batch = drivers.gen_batch(family, train_rng, train_cfg.n_nodes, 1)
        for fn in counted:
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_state, info = step_fn(train_state, batch, train_gen)
        torch.cuda.synchronize()
        train_rows.append({"step": i, "loss": info.loss.item(), "mean_cost": info.mean_cost.item(),
                           "grad_norm": info.grad_norm.item(),
                           "wall_ms": (time.perf_counter() - t0) * 1e3, "phase_ms": timer.take(),
                           "launches": {fn.__name__: fn.launches for fn in counted}})
    depth = train_state.net.depth
    want_step = {"fused_gnn_layer": depth, "fused_gnn_layer_backward": depth,
                 "fused_pick": 0, "fused_rollout": 1, "fused_rollout_backward": 1,
                 "cvrp_construct": 0, "embnet_layers": 0}
    step_launches_ok = all({k: r["launches"][k] for k in want_step} == want_step
                           for r in train_rows)
    train_finite = all(math.isfinite(r[key]) for r in train_rows
                       for key in ("loss", "mean_cost", "grad_norm"))
    train_moved = all(not torch.equal(start[k], v)
                      for k, v in train_state.net.state_dict().items()
                      if v.dim() == 2 or "running" in k)
    cvrp_train_launches = {fn.__name__: sum(r["launches"][fn.__name__] for r in train_rows)
                           for fn in counted}
    # one more step under the profiler: the device's busy time, idle share
    # and launches a step
    spare = copy.deepcopy(train_state)
    batch = drivers.gen_batch(family, train_rng, train_cfg.n_nodes, 1)
    cvrp_profiled = device_busy(lambda: step_fn(spare, batch, train_gen))
    del train_state, start, spare

    # (c) a short train_family run: one epoch cut to 2 steps, validation,
    # checkpoints; -last read back and evaluated
    ckpt_stem = root / "build" / "chip_smoke" / "cvrp500_trained"
    written = [ckpt_stem.with_name(ckpt_stem.name + s + ".msgpack") for s in ("-best", "-last")]
    for f in written:
        f.unlink(missing_ok=True)
    epochs = []
    for fn in counted:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fam_state = drivers.train_family("cvrp", train_cfg, progress=lambda *a: epochs.append(a),
                                     val_instances=CVRP_VAL_B, val_t=2,
                                     ckpt_path=str(ckpt_stem) + ".msgpack", max_steps=2)
    torch.cuda.synchronize()
    family_wall = time.perf_counter() - t0
    family_launches = {fn.__name__: fn.launches for fn in counted}
    tree = load_checkpoint(str(written[1]))
    reloaded = drivers.family_model(family, tree).to(dev)
    same = all(torch.equal(a, b) for a, b in zip(fam_state.net.state_dict().values(),
                                                   reloaded.state_dict().values()))
    reload_means, reload_curves = drivers.evaluate_family(
        "cvrp", {k: v[:CVRP_VAL_B] for k, v in cvrp_ds.items()}, n_nodes=CVRP_N,
        net=reloaded, n_ants=A, t_values=(1,), seed=SEED)
    family_ok = (all(f.exists() for f in written) and same and int(tree["step"]) == 2
                 and fam_state.step == 2 and len(epochs) == 1 and len(epochs[0]) == 3
                 and all(math.isfinite(v) for v in epochs[0][1:])
                 and bool(torch.isfinite(reload_curves).all()))
    del fam_state, reloaded

    # (d) the CLI's test cvrp on the card: phase 10's kernel arm
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli_means, _ = cli.main(["test", "cvrp", "-n", str(CVRP_N), "-c", str(root / CVRP_CKPT),
                                 "-a", str(A), "--seed", str(SEED), "-t", *map(str, T_VALUES)])
    cli_lines = out.getvalue().splitlines()
    cli_ok = ([round(float(v), 4) for v in cli_means] == list(RECORDED_COSTS["cvrp"])
              and cli_lines[1:-1] == [f"T={t}, average cost is {v:.6f}."
                                      for t, v in zip(T_VALUES, cli_means)])
    cvrp_train_ok = {"step_agreement": step_check["passed"],
                     "k6_forward": layer_train["passed"],
                     "k6_backward": layer_train["backward"]["passed"],
                     "k7r": rollout_train["passed"], "step_launches": step_launches_ok,
                     "finite": train_finite, "weights_moved": train_moved,
                     "train_family": family_ok, "cli": cli_ok}
    emit({"phase": "cvrp_train", "B": 1, "N": CVRP_N + 1, "A": A_TRAIN,
          "lr": train_cfg.train.lr, "checks": cvrp_train_ok, "step_agreement": step_check,
          "steps": train_rows, "launches_per_step_expected": want_step,
          "profiled_step": cvrp_profiled,
          "train_family": {"steps": 2, "val_instances": CVRP_VAL_B, "val_t": 2,
                           "wall_s": family_wall, "epochs": epochs, "launches": family_launches,
                           "files": [str(f.relative_to(root)) for f in written],
                           "reloaded_weights_equal": same,
                           "reloaded_cost_t1": reload_means.tolist()},
          "cli": {"argv": ["test", "cvrp", "-n", str(CVRP_N), "-c", CVRP_CKPT],
                  "lines": cli_lines, "recorded": RECORDED_COSTS["cvrp"]}})

    # ---- 12. K9 and row 9 against their plain versions
    sparse_net, sparse_g = sparse_inputs(root, dev)
    kernels.append(check_embnet_layers(cuda_ms, sparse_net, sparse_g, "sparse tsp2000, K = 200"))
    del sparse_net, sparse_g
    kernels.append(check_row9(dev, cuda_ms, torch.log(heu[0])))

    # ---- 13. the sparse path: kernel, plain, classic and classic + 2-opt arms
    from deepaco_tpu_torch.aco import large_tsp

    sparse_counted = (fused_gnn.embnet_layers, two_opt.batched_two_opt_euclid,
                      bt.tsp_sweep_construct)

    def sparse_run(args, ops):
        """One call of the sparse path; the kernels' counts are set to 0 just
        before it and read just after."""
        timer, stats = PhaseTimer(), {}
        for fn in counted + sparse_counted:
            fn.launches = 0
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        means, curves, lines = drive_sparse(args, ops._replace(timer=timer), stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b, t_max = curves.shape
        if not bool(torch.isfinite(curves).all()) or t_max != max(args.t_aco):
            fail(f"bad sparse curves {tuple(curves.shape)}")
        if not bool((curves[:, 1:] <= curves[:, :-1]).all()):
            fail("a sparse anytime curve rose")
        best = stats["best"]
        ident = torch.arange(SPARSE_N, device=dev).expand_as(best)
        recost = large_tsp.tour_cost_coords(stats["coords"], best[..., None])[:, 0]
        return {"B": b, "T": list(args.t_aco), "cost": means.tolist(), "cli": lines,
                "wall_s": wall, "tours_per_s": b * t_max * A / wall,
                "phase_ms": timer.ms(),
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9,
                "launches": {fn.__name__: fn.launches for fn in sparse_counted},
                "fallback_rate": stats["fallback_steps"] / stats["ant_steps"],
                "dropped_deposit_rate": stats["off_support_edges"] / stats["tour_edges"],
                "valid_best_tours": int((torch.sort(best, dim=1).values == ident).all(1).sum()),
                "best_cost_is_tour_cost": bool(torch.allclose(recost, curves[:, -1], rtol=1e-5))}

    sparse_arms = {
        "kernel": sparse_run(sparse_args(root), large_tsp.KERNEL_OPS),
        "plain": sparse_run(sparse_args(root), large_tsp.PLAIN_OPS),
        "classic": sparse_run(sparse_args(root, "--classic"), large_tsp.KERNEL_OPS),
        "classic_2opt": sparse_run(sparse_args(root, "--classic", "--local-search", "2opt",
                                               t_values=SPARSE_LS_T, limit=SPARSE_LS_B),
                                   large_tsp.KERNEL_OPS)}
    emit({"phase": "sparse_path", "N": SPARSE_N, "K": SPARSE_N // 10, "A": A,
          "ckpt": CKPT, "jax_recorded": {"fallback_rate": 0.00387,
                                         "dropped_deposit_rate": 0.00432,
                                         "classic_cost_t5_one_instance": 164.003},
          **sparse_arms})

    path_launches = {**launches,
                     "embnet_layers": (sparse_arms["kernel"]["launches"]["embnet_layers"]
                                       + cvrp_arms["kernel"]["launches"]["embnet_layers"]),
                     "tsp_sweep_construct": sparse_arms["kernel"]["launches"]["tsp_sweep_construct"],
                     "tour_deposit": cvrp_arms["kernel"]["launches"]["tour_deposit"],
                     "cvrp_construct": cvrp_arms["kernel"]["launches"]["cvrp_construct"],
                     "batched_two_opt_euclid": arms["classic_2opt"]["launches"]["batched_two_opt_euclid"],
                     "batched_nls_euclid": arms["nls"]["launches"]["batched_nls_euclid"],
                     # K7 steps only past K7r's caps: phase 18's run there (set
                     # after it)
                     "fused_pick": None,
                     **{fn.__name__: train_launches[fn.__name__] for fn in (
                         gnn_layer.fused_gnn_layer, gnn_layer.fused_gnn_layer_backward,
                         rollout_ops.fused_rollout, rollout_ops.fused_rollout_backward)}}
    train_shapes = {"fused_gnn_layer": layer_train, "fused_gnn_layer_backward":
                    {**layer_train["backward"], **{k: layer_train[k] for k in ("B", "N", "K")}},
                    **rollout_entries(rollout_train)}
    for entry in kernels:
        entry["launches"] = path_launches[entry["name"]]
        shape = train_shapes.get(entry["name"])
        if shape is not None:
            entry["cvrp_train"] = {
                "launches": cvrp_train_launches[entry["name"]], "steps": CVRP_TRAIN_STEPS,
                **{k: shape[k] for k in ("config", "B", "N", "K", "A", "T", "ant_steps", "rows",
                                         "max_abs_err", "ms", "device_ms", "plain_ms",
                                         "bound_ms", "bound_by") if k in shape}}
        if entry["name"] in ("fused_rollout", "fused_rollout_backward"):
            entry["tsp500"]["train_launches"] = train_runs["tsp500"][1][entry["name"]]

    # ---- 14. the other families: OP300, PCTSP500, SMTWTP500, SOP100, BPP120, MKP300
    family_runs = {name: family_phase(dev, root, cuda_ms, PhaseTimer, counted, name)
                   for name in FAMILY_PHASE}
    # K7r's untraced forward, the inference rollouts' kernel: SMTWTP500's
    # shape at the top, its launches from phase 18's test tsp family path
    paths_check = family_runs["smtwtp"]["k7r_paths"]
    kernels.append({
        "name": "fused_rollout_paths", "route": "cuda",
        "source": "deepaco_tpu_torch/csrc/rollout.cu",
        "replaces": "deepaco_tpu/ops/pallas_kernels.py:65 (fused_pick_pallas, every step of "
                    "the scan deepaco_tpu/aco/engine.py:104-129 without require_prob)",
        "passed": all(r["k7r_paths"]["passed"] for r in family_runs.values()
                      if "k7r_paths" in r),
        **{k: paths_check[k] for k in ("config", "B", "N", "A", "T", "ant_steps", "max_abs_err",
                                       "ms", "device_ms", "traced_ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by", "peak_gb")}})
    for name, r in family_runs.items():
        fields = family_kernel_fields(r)
        for entry in kernels:
            if entry["name"] in fields:
                entry[name] = fields[entry["name"]]

    # ---- 15. CVRP-NLS500: K7c at capacity 1, K8 on rewritten routes, the
    # native engine in the loop, training on the LS costs
    nls_run = cvrp_nls_phase(dev, root, cuda_ms, PhaseTimer, counted)
    take = lambda d, keys: {k: d[k] for k in keys if k in d}
    timing = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    nls_launches = nls_run["arms"]["kernel"]["launches"]
    for name, fields in rollout_entries(nls_run["k7r"]).items():
        next(k for k in kernels if k["name"] == name)["cvrp_nls"] = {
            "train_launches": nls_run["train_launches"][name], **fields}
    for entry in kernels:
        if entry["name"] == "cvrp_construct":
            entry["cvrp_nls"] = {"launches": nls_launches["cvrp_construct"],
                                 "train_launches": nls_run["train_launches"]["cvrp_construct"],
                                 **take(nls_run["k7c"], timing)}
        if entry["name"] == "tour_deposit":
            entry["cvrp_nls"] = {"launches": nls_launches["tour_deposit"],
                                 **take(nls_run["k8"], ("B", "L", "A", "n") + timing)}

    # ---- 16. MKP-items 500: the transformer, K7r's "items" kind, the vector
    # pheromone
    items_run = family_phase(dev, root, cuda_ms, PhaseTimer, counted, "mkp_items")
    fields = family_kernel_fields(items_run)
    for entry in kernels:
        if entry["name"] in fields:
            entry["mkp_items"] = fields[entry["name"]]

    # ---- 17. RCPSP j120: K7r (SOP's kind) on the direct evaluation, K8 on
    # the elitist update, K7r (the "blend" kind) on the blend
    rcpsp_run = rcpsp_phase(dev, root, cuda_ms, PhaseTimer, counted)
    # ---- 18. test tsp on a golden file: the family path, batched and
    # per-instance local search through the ACO facade; the facade past
    # K7r's caps, K7 a step
    golden_run = tsp_golden_phase(dev, root, cuda_ms, counted, coords)
    past_run = k7_past_caps_run(dev, cuda_ms, counted)
    rcpsp_launches = rcpsp_run["arms"]["kernel"]["launches"]
    facade_launches = golden_run["arms"]["tsp_nls_per_instance"]["launches"]
    # K7 steps only past K7r's caps: phase 18's run there; the TSP inference
    # rollouts take K7r's untraced forward: test tsp's family path
    path_launches["fused_pick"] = past_run["launches"]["fused_pick"]
    path_launches["fused_rollout_paths"] = golden_run["arms"]["tsp_family"]["launches"][
        "fused_rollout_paths"]
    two_opt_launches = golden_run["arms"]["tsp_2opt_per_instance"]["launches"]
    for entry in kernels:
        if entry["name"] == "fused_pick":
            entry["launches"] = path_launches["fused_pick"]
            entry["rcpsp"] = {"launches": rcpsp_launches["fused_pick"],
                              "train_launches": rcpsp_run["train_launches"]["fused_pick"]}
            entry["rcpsp_blend"] = {"launches": rcpsp_run["blend"]["launches"]["fused_pick"],
                                    "train_launches":
                                        rcpsp_run["blend_step_launches"]["fused_pick"]}
            entry["past_caps"] = {"launches": past_run["launches"]["fused_pick"],
                                  "N": past_run["N"], "A": A, "T": K7_PAST_T,
                                  "wall_s": past_run["wall_s"],
                                  **take(past_run["k7"], ("rows",) + timing)}
        if entry["name"] in ("fused_rollout", "fused_rollout_backward"):
            entry["rcpsp"] = {"train_launches": rcpsp_run["train_launches"][entry["name"]],
                              "train_steps": RCPSP_TRAIN_STEPS,
                              **rollout_entries(rcpsp_run["rollout_train"])[entry["name"]]}
            entry["rcpsp_blend"] = {
                "train_launches": rcpsp_run["blend_step_launches"][entry["name"]],
                "train_steps": 1, **RCPSP_BLEND,
                **rollout_entries(rcpsp_run["rollout_blend_train"])[entry["name"]]}
        if entry["name"] == "fused_rollout_paths":
            paths_keys = ("config", "B", "N", "A", "T", "ant_steps", "device_ms", "traced_ms",
                          "peak_gb") + timing
            entry["rcpsp"] = {"launches": rcpsp_launches["fused_rollout_paths"],
                              **take(rcpsp_run["k7r_paths"], paths_keys)}
            entry["rcpsp_blend"] = {
                "launches": rcpsp_run["blend"]["launches"]["fused_rollout_paths"],
                "T": RCPSP_BLEND_T, "wall_s": rcpsp_run["blend"]["wall_s"], **RCPSP_BLEND,
                **take(rcpsp_run["k7r_blend_paths"], paths_keys)}
            entry["launches"] = path_launches["fused_rollout_paths"]
            entry["tsp_facade"] = {"launches": facade_launches["fused_rollout_paths"],
                                   **take(golden_run["k7r_paths"],
                                          ("B", "N", "A", "T", "device_ms") + timing)}
        if entry["name"] == "tour_deposit":
            entry["rcpsp"] = {"launches": rcpsp_launches["tour_deposit"],
                              **take(rcpsp_run["k8"], ("B", "L", "A", "n") + timing)}
            entry["tsp_facade"] = {"launches": facade_launches["tour_deposit"],
                                   **take(golden_run["k8"], ("B", "L", "A", "n") + timing)}
            entry["rcpsp_blend"] = {"launches": rcpsp_run["blend"]["launches"]["tour_deposit"]}
            entry["past_caps"] = {"launches": past_run["launches"]["tour_deposit"]}
        if entry["name"] == "batched_two_opt_euclid":
            entry["tsp_facade"] = {"launches": two_opt_launches["batched_two_opt_euclid"],
                                   **take(golden_run["ls"][entry["name"]],
                                          ("B", "A", "N") + timing)}
        if entry["name"] == "batched_nls_euclid":
            entry["tsp_facade"] = {"launches": facade_launches["batched_nls_euclid"],
                                   **take(golden_run["ls"][entry["name"]],
                                          ("B", "A", "N") + timing)}

    # ---- 19. the remaining single-card paths: reference .pt checkpoints
    # through the CLI, the adaptive CVRP baseline, the sparse-support
    # runner, the MKP-items single-instance step
    rest_run = remaining_phase(dev, root, cuda_ms, counted, net, coords, wall)
    sparse_launches = rest_run["sparse"]["kernel"]["launches"]
    adaptive_launches = {k: sum(r["launches"][k] for r in rest_run["adaptive"])
                         for k in ("cvrp_construct", "tour_deposit")}
    new_paths = {
        "tsp_dense_heuristic": {"sparse_runner": {"launches": sparse_launches[
            "tsp_dense_heuristic"]}},
        "fused_tsp_update": {"sparse_runner": {"launches": sparse_launches["fused_tsp_update"],
                                               "score": "f32",
                                               **take(rest_run["k3_f32"], timing)}},
        "embnet_layers": {"reference_pt": {"launches": rest_run["cli"]["cvrp_pt"]["launches"][
            "embnet_layers"]}},
        "cvrp_construct": {"reference_pt": {"launches": rest_run["cli"]["cvrp_pt"]["launches"][
                               "cvrp_construct"]},
                           "adaptive_cvrp": {"launches": adaptive_launches["cvrp_construct"],
                                             "instances": ADAPTIVE_B, "B": 1,
                                             **take(rest_run["k7c"], timing)}},
        "tour_deposit": {"reference_pt": {"launches": rest_run["cli"]["cvrp_pt"]["launches"][
                             "tour_deposit"]},
                         "adaptive_cvrp": {"launches": adaptive_launches["tour_deposit"],
                                           **take(rest_run["k8"], ("B", "L", "A", "n") + timing)}},
        "fused_rollout_paths": {"reference_pt": {"launches": rest_run["cli"]["mkp_items_pt"][
                                    "launches"]["fused_rollout_paths"]}},
        **{name: {"mkp_items_step": {"launches": rest_run["items_step"]["step_launches"][name]}}
           for name in ("fused_rollout", "fused_rollout_backward")}}
    for entry in kernels:
        entry.update(new_paths.get(entry["name"], {}))

    # ---- 20. the multi-GPU paths: the row-sharded forward, the sharded
    # train step, evaluate_family over a mesh, the island search
    par = parallel_phase(dev, root, cuda_ms, net, coords)
    par_steps = par["train_steps"][0]["launches"]
    par_worlds = {"world_sizes": par["world_sizes"]}
    par_paths = {
        "fused_gnn_layer": {"parallel": {
            "rows_launches": sum(f["launches"] for k, f in par["forward"].items()
                                 if k in ("eval", "train")),
            "train_launches": par_steps["fused_gnn_layer"], "steps": 1,
            **take(par["k6_rows"], ("R", "N", "K") + timing), **par_worlds}},
        "fused_gnn_layer_backward": {"parallel": {
            "train_launches": par_steps["fused_gnn_layer_backward"], "steps": 1,
            **par_worlds}},
        "fused_pick": {"parallel": {
            "train_launches": par_steps["fused_pick"], "steps": 1, **par_worlds}},
        "fused_rollout_paths": {"parallel": {
            "island_launches": par["island"]["launches"]["fused_rollout_paths"], **par_worlds}},
        **{name: {"parallel": {"train_launches": par_steps[name], "steps": 1, **fields,
                               **par_worlds}}
           for name, fields in rollout_entries(par["k7r"]).items()},
        "tour_deposit": {"parallel": {
            "launches": par["cvrp"]["launches"]["tour_deposit"],
            "island_launches": par["island"]["launches"]["tour_deposit"],
            **take(par["k8"], ("B", "L", "A", "n") + timing), **par_worlds}},
        "cvrp_construct": {"parallel": {
            "launches": par["cvrp"]["launches"]["cvrp_construct"], **par_worlds}},
        "embnet_layers": {"parallel": {
            "launches": par["cvrp"]["launches"]["embnet_layers"], **par_worlds}}}
    for entry in kernels:
        entry.update(par_paths.get(entry["name"], {}))

    # ---- 21. the kernels' line
    emit({"kernels": kernels})
    failed = [k["name"] for k in kernels if not k["passed"]]
    if failed:
        fail(f"kernels disagree with their plain versions: {failed}")
    if not row8_ok:
        fail("gated_mean_aggregate (row 8, K6 without pre) disagrees with its plain version")
    on_paths = {k: v for k, v in path_launches.items() if k != "tsp_sweep_construct"}
    if min(on_paths.values()) <= 0:
        fail(f"a kernel never launched on its path: {path_launches}")
    if abs(means[-1] - plain[-1]) > 0.01 * plain[-1]:
        fail(f"kernel path cost@T10 {means[-1]} vs plain {plain[-1]}")
    if not means[-1] < classic[-1]:
        fail(f"neural cost@T10 {means[-1]} not below classic {classic[-1]}")
    nls, nls_plain = arms["nls"]["cost"], arms["nls_plain"]["cost"]
    if abs(nls[-1] - nls_plain[-1]) > 0.01 * nls_plain[-1]:
        fail(f"NLS kernel path cost@T10 {nls[-1]} vs plain {nls_plain[-1]}")
    if not nls[0] < means[-1]:
        fail(f"NLS cost@T1 {nls[0]} not below the main path's cost@T10 {means[-1]}")
    failed_steps = [c["config"] for c in step_checks if not c["passed"]]
    if failed_steps:
        fail(f"kernel and plain train steps disagree: {failed_steps}")
    if not reload_ok:
        fail("the saved training state did not reload and evaluate")
    k8 = next(k for k in kernels if k["name"] == "tour_deposit")
    if not k8["below_library"]:
        fail(f"K8 is not faster than scatter_add: {k8['ms']} / {k8['library_ms']} ms (CVRP), "
             f"{k8['tsp_ms']} / {k8['tsp_library_ms']} ms (TSP)")
    if not layer_501["passed"]:
        fail("K6 disagrees with its plain version at K = N = 501")
    if not k9_501["passed"]:
        fail("K9 disagrees with its plain version on the CVRP path's graph")
    if not pick_501["passed"]:
        fail("K7 disagrees with its plain version on the CVRP rollout's rows")
    if not all(cvrp_train_ok.values()):
        fail(f"CVRP training: {cvrp_train_ok}")
    ck, cp, cc = (cvrp_arms[arm]["cost"] for arm in ("kernel", "plain", "classic"))
    # the two arms draw the same noise, so at T1 only K9's rounding (1e-6)
    # can part them; a wrong pick moves cost@T1 by far more than 1e-4
    if abs(ck[0] - cp[0]) > 1e-4 * cp[0]:
        fail(f"CVRP kernel path cost@T1 {ck[0]} vs plain {cp[0]}")
    if abs(ck[-1] - cp[-1]) > 0.01 * cp[-1]:
        fail(f"CVRP kernel path cost@T10 {ck[-1]} vs plain {cp[-1]}")
    if abs(ck[-1] - PER_STEP_CVRP_T10) > 0.01 * PER_STEP_CVRP_T10:
        fail(f"CVRP kernel path cost@T10 {ck[-1]} vs the per-step route's {PER_STEP_CVRP_T10}")
    if not ck[-1] < cc[-1]:
        fail(f"CVRP neural cost@T10 {ck[-1]} not below classic {cc[-1]}")
    for arm, r in cvrp_arms.items():
        if r["valid_best_routes"] != cvrp_b or not r["best_cost_is_route_cost"]:
            fail(f"CVRP {arm} arm: {r['valid_best_routes']} of {cvrp_b} best routes valid, "
                 f"costs match {r['best_cost_is_route_cost']}")
    t_max = max(T_VALUES)
    want = {"kernel": {"embnet_layers": 1, "fused_gnn_layer": 0, "fused_pick": 0,
                       "tour_deposit": t_max, "cvrp_construct": t_max},
            "plain": {"embnet_layers": 0, "fused_gnn_layer": 0, "fused_pick": 0,
                      "tour_deposit": 0, "cvrp_construct": 0},
            "classic": {"embnet_layers": 0, "fused_gnn_layer": 0, "fused_pick": 0,
                        "tour_deposit": t_max, "cvrp_construct": t_max}}
    for arm, counts in want.items():
        if cvrp_arms[arm]["launches"] != counts:
            fail(f"CVRP {arm} arm launched {cvrp_arms[arm]['launches']}, expected {counts}")
    sk, sp = sparse_arms["kernel"]["cost"], sparse_arms["plain"]["cost"]
    # the two arms draw the same noise; only K9's rounding parts them
    if abs(sk[0] - sp[0]) > 1e-4 * sp[0]:
        fail(f"sparse kernel path cost@T1 {sk[0]} vs plain {sp[0]}")
    if abs(sk[-1] - sp[-1]) > 0.01 * sp[-1]:
        fail(f"sparse kernel path cost@T10 {sk[-1]} vs plain {sp[-1]}")
    sparse_want = {"kernel": {"embnet_layers": 1, "batched_two_opt_euclid": 0},
                   "plain": {"embnet_layers": 0, "batched_two_opt_euclid": 0},
                   "classic": {"embnet_layers": 0, "batched_two_opt_euclid": 0},
                   "classic_2opt": {"embnet_layers": 0,
                                    "batched_two_opt_euclid": max(SPARSE_LS_T)}}
    for arm, r in sparse_arms.items():
        if r["valid_best_tours"] != r["B"] or not r["best_cost_is_tour_cost"]:
            fail(f"sparse {arm} arm: {r['valid_best_tours']} of {r['B']} best tours valid, "
                 f"costs match {r['best_cost_is_tour_cost']}")
        got = {k: r["launches"][k] for k in sparse_want[arm]}
        if got != sparse_want[arm]:
            fail(f"sparse {arm} arm launched {r['launches']}, expected {sparse_want[arm]}")
    if not sparse_arms["classic_2opt"]["cost"][0] < sparse_arms["classic"]["cost"][0]:
        fail("2-opt did not shorten the classic arm's tours at T1")
    for name, r in {**family_runs, "cvrp_nls": nls_run, "mkp_items": items_run,
                    "rcpsp": rcpsp_run, "tsp_golden": golden_run, "k7_past_caps": past_run,
                    "remaining_paths": rest_run, "parallel": par}.items():
        if not all(r["checks"].values()):
            fail(f"{name}: {r['checks']}")
    costs = {"main": means, "main_plain": plain, "nls": nls, "nls_plain": nls_plain,
             "cvrp": ck, "sparse": sk, "sparse_plain": sp,
             **{name: r["arms"]["kernel"]["cost"] for name, r in family_runs.items()},
             "cvrp_nls": nls_run["arms"]["kernel"]["cost"],
             "mkp_items": items_run["arms"]["kernel"]["cost"],
             "rcpsp": rcpsp_run["arms"]["kernel"]["cost"],
             "rcpsp_backfill": rcpsp_run["arms"]["backfill"]["cost"],
             **{key: r["cost"] for key, r in golden_run["arms"].items()},
             "adaptive_cvrp": rest_run["adaptive_cost"], "elitist_cvrp": rest_run["elitist_cost"],
             "sparse_runner": rest_run["sparse"]["kernel"]["cost"],
             "sparse_runner_plain": rest_run["sparse"]["plain"]["cost"],
             "island": par["island"]["cost"]}
    # a one-rank mesh runs block 0 with the seed itself: the CVRP path's costs
    if [round(c, 4) for c in par["cvrp"]["cost"]] != list(RECORDED_COSTS["cvrp"]):
        fail(f"evaluate_family(mesh=) cost {par['cvrp']['cost']} differs from the CVRP "
             f"path's recorded {RECORDED_COSTS['cvrp']}")
    for path, recorded in RECORDED_COSTS.items():
        for got, want in zip(costs[path], recorded):
            if want is not None and round(got, 4) != want:
                fail(f"{path} path cost {costs[path]} differs from the recorded {recorded}")
    return finish()


def finish() -> int:
    """The card's line again and, last, the ``ok`` line; returns 0."""
    import torch

    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
