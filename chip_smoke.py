#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  -- require CUDA, turn TF32 off, report the card;
2. build   -- compile every kernel of the port from ``src/repro_torch/csrc``
              with nvcc for sm_90a, one nvcc per source, all at once
              (ptxas report included): ``kmeans_assign``, ``ssd_scan`` and
              ``flash_attention`` (the bf16 and f32 instances' shared
              memory of the last two, each f32 entry's registers and
              spills, and the tensor-core instructions in each instance's
              SASS by ``cuobjdump``: every bf16 instance must have some,
              no f32 instance any, and no f32 entry may spill);
3. kernel  -- hold each kernel against its plain PyTorch version on the
              card, at the reference tests' shapes and the main paths'
              (the batched ``kmeans_assign`` also under ``torch.func.vmap``
              over 24 cells: one launch, bit-equal to 24), and at the
              shapes the wrappers' plans reach: head dims no instance has
              (zero-padded), SSD chunks above 128 (sub-chunks), bf16 P and
              N off the 16-wide tiles (padded), K-means centre sets beyond
              one block (tiles, a tie across a tile boundary); the one
              refusal left of each (D = 512, N = 512) in both dtypes;
4. slice   -- the paper's host EL loop at full width: kmeans-traffic
              (20,000 samples, 4 edges, batch 128, budget 5000 per edge)
              through ``ELSession.run_sync`` and ``run_async`` on the card;
              the same runs on the CPU with the plain E-step must make the
              same decisions; then svm-wafer sync at full width;
4b. compiled -- the same two workloads through the compiled sync round
              (``ELSession.run_sync_ingraph``: chunks of masked rounds,
              each a CUDA graph replay, the bandit on the card, every
              K-means local step one launch of ``kmeans_assign``'s batched
              entry): on draws replayed from a seeded CPU generator the
              card's decisions must equal the port's own CPU run's; then
              on the card's own generator, run seconds, rounds, chunks
              (host syncs), graphs, replays and kernel launches beside the
              host loop's seconds;
4c. async  -- the same two workloads through the compiled async event
              engine (``ELSession.run_async_ingraph``: chunks of masked
              event steps, each a CUDA graph replay, one bandit per edge
              on the card, every K-means local step one launch of
              ``kmeans_assign``'s batched entry), single events and
              K-event waves of 4: on replayed draws the card's events
              (order, intervals, charges, times) must equal the port's
              CPU run's, and the waves' the single events'; then on the
              card's own generator, run seconds, events, chunks, graphs,
              replays and kernel launches beside the host ``run_async``'s
              seconds;
4d. sweep  -- the same two workloads through ``ELSession.sweep``: a sync
              grid of 24 cells (ucb_c x budget x heterogeneity x seeds) and
              an async grid of two sub-sweeps of 8 (wave widths 1 and 4),
              each cell a row of one device loop, its masked step vmapped
              over the cells (one CUDA graph replay a chunk, every K-means
              local step one ``kmeans_assign`` launch over all (cell,
              edge) pairs), with functorch's per-cell fallback warning an
              error; every cell's decisions must equal a solo run of its
              config on the card, the K = 4 cells their K = 1 twins; sweep
              seconds (capture, then reuse) beside the solo runs' sum,
              chunks, replays, launches and the draw refill's host ms;
4e. scenarios -- the scenario engine: one scenario (20 % dropout on a
              32-round schedule, Pareto(2) straggler spikes on a 64-round
              one, drift 0.01; fixed cost) through ``run_sync_ingraph``
              under each policy of the switch (``ol4el``, ``task_alloc``,
              ``delay_energy``) and ``run_async_ingraph`` (K = 1): on
              replayed draws every decision field of the card's ``out``
              must equal the CPU run's and ``verify_sync_replay`` must
              hold each sync run; then on the card's own generator, run
              seconds, rounds, chunks, replays and launches; then the
              churn benchmark's grid (3 policies x churn 0 / 0.2 / 0.4 x
              seeds 0 / 1 / 2) through ``ELSession.sweep`` on svm-wafer
              (the benchmark's data) and kmeans-traffic, every cell equal
              to a solo run of its config (phase 4g holds the same grid's
              svm seed-means against ``BENCH_churn_baselines.json``); past
              the counted runs, each run's card time (profiled busy share,
              kernels a chunk round, replay ms, idle share by CUDA events)
              beside the scenario-less round's and event's;
4f. fleet  -- ``FleetServer`` (``repro_torch.el.fleet``) over the same
              fixtures: three cohorts (kmeans-traffic sync and async K = 1,
              svm-wafer sync), 8 tenants each through 4 slots in waves of
              16 steps (one CUDA graph replay a wave, every K-means local
              step one ``kmeans_assign`` launch over 16 (slot, edge)
              pairs), one tenant a cohort at priority 2, the rest admitted
              as slots free; 3 builds, one graph a cohort, dispatches at
              most one a wave, every tenant's streamed deltas its records
              and its report bit for bit its solo run's on the card; a
              second drain on a fresh server sharing the cache, with a
              JSONL tracer, reuses the graphs and gives the same reports;
              drain and cohort seconds beside the solo runs' sum, host ms
              a wave in admit / step / harvest; past the counted runs one
              cohort's card time;
4h. rings -- the device telemetry rings and program profiles
              (``repro_torch.obs.rings`` / ``prof``) through every compiled
              path at the same width: the sync round (rings of 128 and of
              16, which wraps), the async engine at K = 1 and 4 (234 / 224
              events wrap the default ring), the scenario round and event
              body (phase 4e's scenario), each run equal bit for bit to
              the same run with the rings off and, at fixed cost outside
              a scenario, its rings to the numpy replay oracle; the sync
              and async programs profiled with the default contract (no
              collectives, nothing aliased, the allocator's chunk peak
              measured) and an impossible contract raising before any
              replay; phase 4d's 24-cell sync grid ringed (the grid the
              unringed one, every cell's rings its solo card run's) and
              phase 4f's kmeans sync cohort ringed and profiled (every
              tenant bit for bit its solo card run, rings included, the
              donated profile on every report); past the counted runs
              each path's seconds with the rings off and on (reused
              graphs, median of 5) and their ratio, and for kmeans sync
              and async K = 1 the kernels a chunk round each side
              (``card_time``);
4g. figures -- the paper's figure harness (``repro_torch.bench``) at its
              ``--full`` sizes, seed 0 only (the preset's 3 / 3 / 2 seeds
              took ~80 s of the script's 1,200 s): Fig. 3 (H 1 to 15,
              20,000 samples), Fig. 4, Fig. 5 (3 / 10 / 30 / 100 edges,
              H 1 / 5 / 15, budget 600, batch 32), the policy ablation
              with its testbed and ``ucb_sweep``, the churn baselines and
              the §V testbed, every K-means local step and evaluation one
              ``kmeans_assign`` launch; each figure must have the
              reference's row count and finite metrics in (0, 1] (svm
              accuracy above 1/8), the churn rows' svm seed-means within
              0.05 of ``BENCH_churn_baselines.json``, and Fig. 3's H = 6,
              seed-0 K-means runs (all 4 algorithms) the same decisions,
              arm pulls and F1 (within one flipped point) when rerun on the
              CPU from the same init (the svm runs report theirs); each
              figure's seconds and kernel launches, Fig. 5's seconds a run
              by edge count, and the reference's claims as booleans
              (``fig3_heterogeneity.py:7-11``, ``fig4_tradeoff.py:3-6``,
              ``fig5_scalability.py:3-6``), reported without a gate;
4i. bench  -- the port's benches and bench gate (``repro_torch.bench``):
              (a) ``microbench.run`` on the card, every row finite, the
              reference's rows in its order plus the ``kmeans_assign``
              kernel row at (4096, 64, 3), every assignment of which must
              equal the plain version's and every distance lie within
              ``ref.allowed_error``; (b) ``bench_fleet`` at 16 tenants
              (its fleet contract: ``fleet_16`` makes
              ``sequential_ingraph_16``'s aggregations); (c)
              ``bench_check --smoke`` (a small ``bench_el`` on the card,
              its four sharded tiers in 4 gloo ranks sharing the card,
              against the committed ``BENCH_torch_el.json``) and (d)
              ``bench_check`` on the committed baselines: a contract or
              ledger finding, or exit code 2, fails; the ratio and overhead
              findings are printed with their rows, ungated; each part's
              seconds;
5. serve   -- mamba2-370m at full width (48 layers, d_model 1024, bf16,
              random weights from a seeded generator) through the port's
              ``ServingEngine``: 4 slots, 8 greedy requests of 16 tokens
              arriving over time (one admitted mid-flight), every Mamba
              layer's prefill through the ``ssd_scan`` kernel; then the
              same prompts' prefill with the plain SSD, compared;
5b. serve_attention -- qwen3-1.7b at full width (28 layers, d_model 2048,
              16 query and 8 KV heads of 128, vocab 151,936, bf16, random
              weights from a seeded generator) through the same engine
              and traffic: every attention layer's prefill fills the KV
              cache (4 slots x 1024 positions) through the
              ``flash_attention`` kernel (28 launches a prefill, the
              mid-flight ones at ragged lengths), the decode attends over
              the cache in plain torch; prefill and decode ms a call, peak
              memory; then the same prompts' prefill with the naive fill,
              logits and every layer's K and V compared at f32 and bf16;
6. train   -- qwen3-1.7b at full width (28 layers, d_model 2048, 16 query
              and 8 KV heads of 128, vocab 151,936, bf16, remat; random
              weights from a seeded generator) through the port's
              ``launch.train.train_standard``: 3 AdamW steps at B = 8,
              S = 512, every attention layer's forward (and its remat
              recompute) through the ``flash_attention`` kernel; then one
              step's loss and gradient norm with the kernel and with the
              plain naive attention, at f32 and bf16, compared;
6b. train_minicpm -- minicpm-2b at full width (40 layers, d_model 2304, 36
              heads of 64 (MHA), vocab 122,753, tied, bf16, remat) through
              the same trainer under its Warmup-Stable-Decay schedule: 3
              AdamW steps at B = 4, S = 512 (after phase 6's state is
              released), every attention forward and remat recompute
              through the kernel at D = 64; finite losses and the
              reference's wsd rates gated; then kernel vs naive as in 6;
5c. serve_moe -- olmoe-1b-7b at full width and depth (16 layers, d_model
              2048, 16 heads of 128 (MHA), qk-norm, 64 experts top-8 of
              d_ff 1024, vocab 50,304, bf16; 6,919,100,416 parameters)
              through ``launch/serve.build`` and the engine on phase 5's
              traffic, after 6b's state is released: 16 ``flash_attention``
              launches a prefill; the first wave's card time; layer 0's MoE
              block at (4, 512, 2048) f32 on the card equal to the CPU's
              (expert choices, y, aux); the kernel fill vs the naive fill at
              f32 (K, V, logits; (token, layer) expert sets agreeing);
5d. serve_deepseek_moe -- deepseek-moe-16b at full width, its depth cut
              from 28 to 4 layers (the 65.3 GB f32 tree would not fit
              safely): a dense prefix layer, then 3 MoE layers of 2 shared
              and 64 routed experts top-6; the same traffic (mid-flight
              admissions scatter the prefix layer's cache rows), a re-run
              whose greedy tokens must be equal, and the checks of 5c;
6c. train_mamba -- mamba2-370m at full width (48 layers) through the same
              trainer: 3 AdamW steps at the experiment's B = 8, S = 512 with
              remat, every layer's SSD forward and remat recompute through
              the ``ssd_scan`` kernel (96 launches a step; the backward
              through the plain ``ssd_reference``); then kernel vs plain SSD
              at f32 (loss 1e-5, gradient norm 1e-4) and bf16, the launches
              counted in the forward and the recompute apart;
6d. train_musicgen -- musicgen-medium at full width and depth (48 layers,
              d_model 1536, 24 heads of 64 (MHA), GeGLU d_ff 6144, 4
              codebooks of vocab 2048: summed embeddings, a head per
              codebook; 1,837,254,144 parameters) through the same
              trainer: 3 AdamW steps at B = 8, S = 512 (tokens [8, 4, 512]),
              288 ``flash_attention`` launches (48 forward + 48 remat
              recompute a step); then kernel vs naive attention at f32
              (loss 1e-5, gradient norm 1e-4) and bf16;
6e. train_paligemma -- paligemma-3b at full width (d_model 2048, 8 query
              heads of 256 and 1 KV head, GeGLU d_ff 16,384, tied vocab
              257,216, 256 prefix embeddings before the text), depth 18
              cut to 4 (967,198,720 parameters; the whole 2,508,662,784
              in the kernel-vs-naive pass): 3 steps at B = 4, S = 512,
              the attention at (4, 768, 8, 1, 256), 24 launches; kernel vs
              naive as in 6d; then ``--ckpt``: the launcher's saved state
              restored into a fresh template equal to the live one bit for
              bit, and one more step from each the same;
5e. serve_musicgen -- musicgen-medium through ``launch/serve.build`` and
              the engine on phase 5's traffic with [4, S] prompts (every
              codebook sampled, codebook 0 recorded, mid-flight admission):
              48 launches a prefill, prefill and decode ms, peak; the
              kernel fill vs the naive fill as in 5b;
5f. serve_paligemma -- paligemma-3b through the engine on phase 5's traffic
              with text prompts (18 launches a prefill at (4, S, 8, 1,
              256)); then ``LM.prefill`` of 256 prefix embeddings and 512
              tokens (18 launches at (4, 768, 8, 1, 256)) and 16 greedy
              decode steps, the cache index at 784; the kernel fill vs the
              naive fill at f32 with the prefix (logits, K, V);
5g. serve_jamba -- jamba-1.5-large-398b at full width (d_model 8192, 64
              query and 8 KV heads of 128, 16 experts top-2 of d_ff 24,576,
              Mamba-2 with 128 heads of 128 and d_state 128), its depth cut
              from 72 layers to layers 2-4 of its group, (MAMBA, DENSE),
              (MAMBA, MOE), (ATTN, DENSE): 12.91 B parameters, a 51.6 GB
              f32 tree; phase 5's traffic through the engine, a re-run
              with equal tokens, flash_attention once and ssd_scan twice a
              prefill (P = N = 128), peak memory and the first wave's card
              time; the kernel fill vs the naive fill at f32 (K, V, SSM and
              conv state, logits; expert sets agreeing, as in 5c);
5h. serve_long_context -- qwen3-1.7b with the reference's long-context
              sliding window of 8192: 2 slots of 12,288-token prompts and
              16 greedy decode steps through the engine, with the masked
              full cache, with ``window_slice`` and with ``ring_cache``
              (8192 slots): each prefill launches flash_attention 28 times
              at window 8192; the three runs' tokens equal, their logits
              within the bf16 model's own rounding of each other;
6f. train_hybrid -- jamba-1.5's (MAMBA, DENSE), (ATTN, DENSE) at full
              width (2.85 B parameters): 3 AdamW steps at B = 8, S = 512,
              flash_attention and ssd_scan each twice a step (remat); then
              kernel vs plain at f32 (loss 1e-5, gradient norm 1e-4) and
              bf16, and the same on the smoke config over two groups of the
              full 8-layer pattern (MoE choices replayed on the plain path);
7. ol4el   -- the paper's loop over qwen3-1.7b at full width
              (``launch.train.train_ol4el``, sync, 2 edges, B = 4,
              S = 128, 2 rounds);
9. planner -- the H100 planner (``repro_torch.launch.dryrun``) on meta
              tensors against the card: each row's predicted peak within
              15 % of the peak measured around one clean step in the phase
              that built the model (5c: olmoe-1b-7b's 4 x 512 prefill; 5d:
              deepseek-moe-16b's, layers 0:4; 6b: minicpm-2b's train step
              at B = 4 and at the experiment's B = 8; 5g: jamba's, layers
              2:5; 6f: the interleave's train step at B = 8), and the
              verdicts of the rows not run (olmoe-1b-7b's training state
              and jamba's layers 0:5 do not fit; deepseek-moe-16b's full
              depth stated); then qwen3-1.7b's 4 x 512 prefill planned and
              measured (``--measure``), its step time beside the port's
              roofline bound (``repro_torch.bench.roofline``); each line
              beside the card's name and power limit;
9b. examples -- ``repro_torch.examples``' quickstart (qwen3-1.7b smoke,
              ``flash_attention`` launched), serve_batched (qwen3-1.7b,
              mamba2-370m and jamba smoke: ``flash_attention`` and
              ``ssd_scan`` launched) and train_lm_ol4el (``--preset 25m
              --rounds 10``, its checkpoint restored bit for bit; then
              ``--preset 5m --rounds 10``, 4 heads of 48 on the f32
              instance at D = 64, ``flash_attention`` launched), and
              ``launch.train --arch kmeans-traffic --mode ol4el
              --kmeans-impl cuda --alpha 1.0`` (``kmeans_assign``
              launched);
10. ranks -- several ranks: 2 gloo ranks on the one card (each this script
              run as ``chip_smoke.py --rank gloo SPEC`` through
              ``repro_torch.launch.hostdev.spawn_ranks``; NCCL puts no two
              ranks of one communicator on one card): (a) phase 4b's
              full-width kmeans-traffic and svm-wafer fixtures through
              ``run_sync_ingraph(mesh=)`` (a rank's 2 of 4 edges, the edge
              stack all-gathered before the aggregation; chunks eager:
              gloo gathers through host memory, which no CUDA graph can
              hold),
              every rank's records and final params bit for bit the
              unsharded card run's on the card's generator, each
              ``kmeans_assign`` launch over 2 lanes, the census (all-gather
              >= 1, no all-reduce) and the donated twin (same records,
              ``alias_bytes == param_bytes``); (b) ``local_sgd.
              make_el_round`` on mamba2-370m at full width (E = 2, h_max
              = 2, 3 rounds, a per-edge batch of 8 whose ``--step
              el_round`` plan must fit 0.8 of the card on 2 ranks) on one
              rank with both edges and on the 2 ranks
              with one edge each: params bit for bit equal, losses finite,
              each rank's peak within 15 % of the plan; (c) an NCCL world
              of one (``chip_smoke.py --rank nccl SPEC``): the sharded
              sync run issues no collective; (i) a CUDA graph holding
              ``gather_edge_stack`` over the world's group and the f32
              edge-order mean, replayed on fresh inputs, bit-equal to the
              same ops run eagerly, its warm-up's census the one NCCL
              all-gather; (ii) phase 4b's kmeans-traffic sync cell over a
              ``PlanMesh(2)`` (rank 0's 2 of 4 edges) captured, then with
              ``capturable=False`` eager: records and params bit-equal, one
              graph, replays, ``kmeans_assign`` launches = replays x
              launches a graph; and the SVM step's lanes against 4 (the
              lone lane recorded: cuBLAS may round it apart, which is
              why a sharded rank of one edge runs its lane beside a
              copy; 2 and 3 lanes and the copy must agree); (d) in (b)'s
              world after (b),
              a (1 data x 2 model) mesh: (b)'s first round (intervals (2,
              2)) on mamba2-370m's first 8 of 48 layers (the cut keeps the
              script inside its time limit), with both edges on each rank
              and each edge's model split
              over the 2 ranks (``init_el_state(mesh=)``, every group's
              weights gathered in its forward and remat recompute, each
              gradient leaf for the clip): every rank's blocks of the
              state (params and AdamW moments) bit for bit the matching
              slices of a one-rank state at the same depth after its
              first round (the
              two ranks' blocks cover every value), losses equal and
              finite, ``ssd_scan`` launched on each rank, each rank's
              peak within 15 % of ``plan_combo(step_mode="el_round",
              model_ranks=2, layers="0:8")``; (e) only with 2 or more cards (else one
              line says why): an NCCL world of ``min(4, cards)`` ranks,
              one a card (``--rank cards``), runs (a)'s two sync runs,
              11 (a)'s async runs (the mesh's K = 4) and 11 (d)'s churn
              runs with their chunks captured, each bit for bit the
              unsharded card run, one graph or more and replays on every
              rank, the census an all-gather and no all-reduce; then a
              world of 2 (``--rank cards_lm``) runs (b)'s round, one edge
              a rank, bit for bit the one-rank round (``python3
              chip_smoke.py --cards`` runs (e) alone, with its
              references), and (f) over its ranks; (f) the ring KV cache
              over ranks: qwen3-1.7b at full width and depth, f32, window
              8192 as a ring (``ring_cache``), batch 1, a prefill of 8,448
              tokens (the ring wraps by 256; 28 ``flash_attention``
              launches through its window branch) and 16 greedy decode
              steps, whole in this process, then in (a)'s world after
              phase 11 on each of the 2 gloo ranks with the filled ring
              split over the (2, 1) mesh, 4096 slots a rank (the
              sequence-split ring decode, partials combined in rank
              order): each rank's logits within 1e-4 of the whole ring
              decode's at every step, its tokens equal; each line beside
              the card's name and power limit;
11. ranks, part 2 -- in phase 10's gloo world, after its runs: (a) phase
              4c's full-width fixtures on its replayed draws through
              ``run_async_ingraph(mesh=, contract=True)`` at K = 1 and at
              the width the mesh resolves (4): every rank's events bit for
              bit phase 4c's unsharded K = 1 card run's and its final
              params the unsharded run's at its K, no graph, the census
              16 all-gathers a chunk of K edges' parameters and no
              all-reduce, each ``kmeans_assign`` launch over K lanes, a
              rerun equal, the donated twin equal with ``alias_bytes ==
              param_bytes``; (b) phase 4d's grids (24 sync cells, 12 a
              rank; 2 x 8 async cells, 4 a rank each) through
              ``sweep(mesh=)``, every cell bit for bit 4d's; (c) phase
              4f's kmeans-traffic async cohort (8 tenants, 4 slots, 2 a
              rank, admitted as slots free) through ``FleetServer(mesh=)``,
              every report 4f's and the streamed deltas its records; (d)
              a churn scenario (rate 0.3, period 16) on kmeans-traffic,
              sync and async, each bit for bit its unsharded card run made
              here; each run's seconds and rerun's beside the unsharded
              run's, a gather's ms, beside the card's name and power limit;
8. kernels -- per-kernel launches, error, times (CUDA events) and bound,
              beside the time of one empty launch (the batched
              ``kmeans_assign`` beside 4 single launches, and at the sweep's
              96 (cell, edge) pairs and the fleet's 16 (slot, edge)
              pairs; the single entry also at the microbenchmark's
              (4096, 64, 3)); ``ssd_scan`` and
              ``flash_attention`` also per instance (bf16 on the tensor
              cores, f32 on the CUDA cores, each bound at its own rate) at
              the serving and the training shape; and ``flash_attention``
              at phase 5b's prefill (4, 512, 16, 8, 128), phase 6b's
              (4, 512, 36, 36, 64), phases 5c / 5d's (4, 512, 16, 16, 128),
              phase 6d's (8, 512, 24, 24, 64), 5e's (4, 512, 24, 24, 64),
              6e's and 5f's prefix prefill (4, 768, 8, 1, 256) and 5f's
              engine prefill (4, 512, 8, 1, 256), 5g's (4, 512, 64, 8, 128),
              6f's (8, 512, 64, 8, 128) and 5h's (2, 12288, 16, 8, 128) at
              window 8192 (its library time SDPA with a boolean band mask)
              and 10 (f)'s f32 (1, 8448, 16, 8, 128) at window 8192,
              and ``ssd_scan`` at phase 6c's (8, 512, 32, 64, 128, 128), 5g's
              (4, 512, 128, 128, 128, 128) (and f32) and 6f's (8, 512, 128,
              128, 128, 128), bf16, each a row of its own; phase 10's
              batched ``kmeans_assign`` at a rank's (2, 128, 64, 3) and
              ``ssd_scan`` at its round's per-edge batch, rows of their
              own; phase 11's batched ``kmeans_assign`` at a rank's wave
              (4, 128, 64, 3) and single event (1, 128, 64, 3), a row of
              its own; phase 9b's ``--preset 5m`` training at f32 (4, 256,
              4, 4, 48), a row of its own; and shapes under their kernels:
              ``flash_attention`` bf16 at (8, 512, 32, 32, 96) (SDPA the
              library), ``ssd_scan`` bf16 at (4, 512, 32, 64, 128) with
              chunk 256, ``kmeans_assign`` at (4096, 128, 1024) (``cdist``
              + ``min`` the library).

Each path (4, 4b, 4c, 4d, 4e, 4f, 4h, 4g, 4i, 5, 5b, 6, 6b, 5c, 5d, 6c, 6d,
6e, 5e, 5f (its engine and its prefix prefill), 5g, 5h (each of its three
runs), 6f, 7, each of 9b's five runs, and in each rank each of 10's and
11's runs) is driven with every kernel's launch count set to 0 just before it and
read just after.
Before phase 8's rows, one line counts each f32 (CUDA-core) instance's
launches on the run's paths, by the phase line they came before.
Then the card's name and power limit (nvidia-smi), and last ``{"ok": true,
"device": {...}}``.
Any failed check exits non-zero, as does a machine without CUDA or a
directory without the repo's sources.  The script imports nothing of JAX and
nothing of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"


T_START = time.perf_counter()
# f32 (CUDA-core) launches of flash_attention and ssd_scan since the last
# line, and by the phase line that followed them (count_f32_launches)
F32_PENDING = {"flash_attention": 0, "ssd_scan": 0}
F32_BY_PHASE = {"flash_attention": {}, "ssd_scan": {}}


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t`` is its seconds since the script started.  The
    f32 launches since the last line are charged to this one's phase."""
    for name, n in F32_PENDING.items():
        if n:
            by = F32_BY_PHASE[name]
            by[phase] = by.get(phase, 0) + n
            F32_PENDING[name] = 0
    print(json.dumps({"phase": phase, **fields,
                      "t": round(time.perf_counter() - T_START, 2)}),
          flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 200, warmup: int = 20,
            queued: bool = False) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, by CUDA events.

    ``queued=False`` times calls as a caller makes them, host enqueue
    included (a launch-bound call is host-bound).  ``queued=True`` first
    parks the stream on a ~0.1 s device sleep, so every launch is already
    enqueued when the card reaches the start event: the card then runs
    them back to back and the time is the device's alone.
    """
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernel vs plain ---------------------------------------------------

# (n, d, k, dtype name): the reference's kernel-test cases, then the main
# path's local-step minibatch and evaluation-set shapes; then the lane-group
# kernel's branches: D = 59 (not a multiple of its 8 lanes: scalar loads)
# in bf16, D = 300 (32 lanes, past the 8 elements a lane keeps), N = 1001
# (not a multiple of the block's 16 points), and more lanes than a bf16
# row has 16-byte vectors (8 lanes for 5 at D = 40, 4 for 3 at D = 24);
# Fig. 5's local-step minibatch of 32 (phase 4g); last centre sets beyond
# one block's shared memory, walked in tiles: 1,000 centres of 64 (two
# tiles), a 1,024-entry codebook at D = 128 (three; phase 8's row), bf16,
# and the widest point the kernel takes (4,096 features, 14 centres a tile)
KM_CASES = [(100, 8, 3, "float32"), (1000, 64, 3, "float32"),
            (513, 59, 8, "float32"), (256, 16, 32, "float32"),
            (300, 64, 3, "bfloat16"), (128, 64, 3, "float32"),
            (4000, 64, 3, "float32"), (200, 59, 3, "bfloat16"),
            (64, 300, 4, "float32"), (1001, 64, 3, "float32"),
            (300, 40, 3, "bfloat16"), (200, 24, 3, "bfloat16"),
            (32, 64, 3, "float32"), (1000, 64, 1000, "float32"),
            (4096, 128, 1024, "float32"), (300, 64, 1000, "bfloat16"),
            (64, 4096, 40, "float32")]
MAIN_SHAPES = [(128, 64, 3), (4000, 64, 3), (32, 64, 3)]
KM_TILED = (4096, 128, 1024)      # phase 8's row of a tiled centre set


def km_inputs(n, d, k, dtype_name, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    x = torch.randn(n, d, generator=g).to("cuda", dtype)
    c = torch.randn(k, d, generator=g).to("cuda", dtype)
    return x, c


def kernel_vs_plain() -> tuple:
    """Returns the largest |d2 - d2_plain| at the main path's shapes, and
    that of each f32 case by (n, d, k)."""
    import torch
    from repro_torch.kernels.kmeans_assign import kernel, ops, ref
    main_err, errs = 0.0, {}
    for i, (n, d, k, dt) in enumerate(KM_CASES):
        x, c = km_inputs(n, d, k, dt, seed=i)
        a, d2 = ops.assign_with_dist(x, c)
        a_ref, d2_ref = ref.assign_ref(x, c)
        torch.cuda.synchronize()
        # f32: the expansion cancels terms of size ||x||^2 ~ D, and the two
        # sides sum in different orders; bf16 inputs as the reference test
        tol = 1e-2 if dt == "bfloat16" else None
        rtol, atol = (tol, tol) if tol else (1e-4, 1e-3)
        err = float((d2 - d2_ref).abs().max())
        close = torch.allclose(d2, d2_ref, rtol=rtol, atol=atol)
        agree = float((a == a_ref).float().mean())
        group, tile = kernel.plan(d, k, kernel.max_smem(0))
        emit("kernel_vs_plain", kernel="kmeans_assign", n=n, d=d, k=k,
             dtype=dt, group=group, centres_a_tile=tile, max_abs_err=err,
             assign_agree=agree)
        check(close, f"kmeans_assign d2 off at {(n, d, k, dt)}: {err}")
        check(dt == "bfloat16" or agree >= 0.999,
              f"kmeans_assign assignments agree {agree} at {(n, d, k, dt)}")
        if dt == "float32":
            errs[n, d, k] = err
        if (n, d, k) in MAIN_SHAPES:
            main_err = max(main_err, err)
    # an exact tie (duplicated centroid) must resolve to the lower index
    x, c = km_inputs(1000, 64, 3, "float32", seed=99)
    c[1] = c[0]
    a, _ = ops.assign_with_dist(x, c)
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    emit("kernel_vs_plain", kernel="kmeans_assign", case="tie",
         picked_duplicate=int((a == 1).sum()),
         assign_agree=float((a == a_ref).float().mean()))
    check(not bool((a == 1).any()), "kmeans_assign tie went to the higher "
          "index")
    check(bool((a == a_ref).all()), "kmeans_assign tie case disagrees")
    # ties across a tile boundary: the last centre of the first tile and
    # the first of the second are one point, as are centre 5 and the last
    n, d, k = KM_TILED
    _, tile = kernel.plan(d, k, kernel.max_smem(0))
    x, c = km_inputs(n, d, k, "float32", seed=98)
    c[tile] = c[tile - 1]
    c[k - 1] = c[5]
    x[:64] = c[tile - 1] + 1e-3 * x[:64]
    x[64:128] = c[5] + 1e-3 * x[64:128]
    a, _ = ops.assign_with_dist(x, c)
    ab, _ = ops.assign_with_dist_batched(x[None], c[None])
    a_ref, _ = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    higher = int(((a == tile) | (a == k - 1)).sum())
    emit("kernel_vs_plain", kernel="kmeans_assign", case="tie across tiles",
         n=n, d=d, k=k, centres_a_tile=tile, picked_higher=higher,
         assign_agree=float((a == a_ref).float().mean()),
         batched_equal=bool(torch.equal(ab[0], a)))
    check(tile < k and higher == 0 and bool((a[:64] == tile - 1).all())
          and bool((a[64:128] == 5).all()),
          "kmeans_assign tie across a tile boundary went to the higher index")
    check(bool((a == a_ref).all()) and bool(torch.equal(ab[0], a)),
          "kmeans_assign tie across tiles disagrees with the plain version "
          "or the batched entry")
    return main_err, errs


# (e, n, d, k, dtype name) of the batched entry: the compiled round's local
# step (4 edges of (128, 64, 3)), N not a multiple of the block's points,
# wafer widths (scalar loads), K = 1, bf16, 1,000 centres an edge (two
# tiles); phase 11 adds each other lane count its runs launch at
KM_BATCHED_CASES = [(4, 128, 64, 3, "float32"), (4, 1001, 64, 3, "float32"),
                    (3, 513, 59, 8, "float32"), (2, 100, 64, 1, "float32"),
                    (3, 300, 64, 3, "bfloat16"), (2, 128, 64, 3, "float32"),
                    (1, 128, 64, 3, "float32"), (3, 300, 64, 1000, "float32")]
KM_BATCHED_MAIN = (4, 128, 64, 3)
KM_BATCHED_SHARDED = (2, 128, 64, 3)      # phase 10: a rank's 2 of 4 edges


def km_batched_inputs(e, n, d, k, dtype_name, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    x = torch.randn(e, n, d, generator=g).to("cuda", dtype)
    c = torch.randn(e, k, d, generator=g).to("cuda", dtype)
    return x, c


def batched_case_vs_plain(e, n, d, k, dt, seed) -> float:
    """The batched entry at one shape bit-equal to E single launches, and
    within the single entry's tolerance of the plain version; returns the
    largest |d2 - d2_plain|."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    x, c = km_batched_inputs(e, n, d, k, dt, seed=seed)
    a, d2 = ops.assign_with_dist_batched(x, c)
    singles = [ops.assign_with_dist(x[j], c[j]) for j in range(e)]
    a_ref, d2_ref = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a[j], sa) and torch.equal(d2[j], sd)
                    for j, (sa, sd) in enumerate(singles))
    tol = (1e-2, 1e-2) if dt == "bfloat16" else (1e-4, 1e-3)
    err = float((d2 - d2_ref).abs().max())
    agree = float((a == a_ref).float().mean())
    emit("kernel_vs_plain", kernel="kmeans_assign_batched", e=e, n=n,
         d=d, k=k, dtype=dt, bit_equal_to_singles=bit_equal,
         max_abs_err=err, assign_agree=agree)
    check(bit_equal, f"kmeans_assign batched != {e} single launches at "
          f"{(e, n, d, k, dt)}")
    check(torch.allclose(d2, d2_ref, rtol=tol[0], atol=tol[1]),
          f"kmeans_assign batched d2 off at {(e, n, d, k, dt)}: {err}")
    check(dt == "bfloat16" or agree >= 0.999,
          f"kmeans_assign batched assignments agree {agree}")
    return err


def kernel_batched_vs_plain() -> dict:
    """:func:`batched_case_vs_plain` at every ``KM_BATCHED_CASES`` shape;
    returns the largest |d2 - d2_plain| at each f32 shape (e, n, d, k)."""
    errs = {}
    for i, (e, n, d, k, dt) in enumerate(KM_BATCHED_CASES):
        err = batched_case_vs_plain(e, n, d, k, dt, seed=50 + i)
        if dt == "float32":
            errs[e, n, d, k] = err
    return errs


def kernel_cells_vs_plain(n_cells: int) -> float:
    """The batched entry under ``torch.func.vmap`` over ``n_cells`` cells
    at the compiled round's local-step shape: the op's vmap rule folds
    (cell, edge) into C·E pairs and launches once, bit-equal to C batched
    launches and within the batched entry's tolerance of the plain
    version; returns the largest |d2 - d2_plain|."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    e, n, d, k = KM_BATCHED_MAIN
    x, c = km_batched_inputs(n_cells * e, n, d, k, "float32", seed=60)
    xv, cv = x.view(n_cells, e, n, d), c.view(n_cells, e, k, d)
    before = ops.batched_launches
    a, d2 = torch.func.vmap(ops.assign_with_dist_batched)(xv, cv)
    vmapped_launches = ops.batched_launches - before
    per_cell = [ops.assign_with_dist_batched(xv[i], cv[i])
                for i in range(n_cells)]
    a_ref, d2_ref = ref.assign_ref(x, c)
    torch.cuda.synchronize()
    bit_equal = all(torch.equal(a[i], pa) and torch.equal(d2[i], pd)
                    for i, (pa, pd) in enumerate(per_cell))
    err = float((d2.reshape(-1, n) - d2_ref).abs().max())
    agree = float((a.reshape(-1, n) == a_ref).float().mean())
    emit("kernel_vs_plain", kernel="kmeans_assign_batched_cells",
         cells=n_cells, e=e, n=n, d=d, k=k, dtype="float32",
         vmapped_launches=vmapped_launches,
         bit_equal_to_per_cell_launches=bit_equal, max_abs_err=err,
         assign_agree=agree)
    check(vmapped_launches == 1,
          f"kmeans_assign under vmap: {vmapped_launches} launches, not 1")
    check(bit_equal, "kmeans_assign under vmap != per-cell launches")
    check(torch.allclose(d2.reshape(-1, n), d2_ref, rtol=1e-4, atol=1e-3),
          f"kmeans_assign under vmap: d2 off by {err}")
    check(agree >= 0.999, f"kmeans_assign under vmap: assignments {agree}")
    return err


# (b, s, h, p, n, chunk, dtype name): the reference's kernel-test cases,
# then the main path's prefill shapes (mamba2-370m: 4 slots, 32 heads of
# 64, d_state 128, chunk 128; the mid-flight prefills of 514-529 tokens
# pad to 640, a lone admitted prompt is B = 1), and ragged chunks (a
# 100-token prompt gives L = 100); then the bf16 (tensor-core) instance's
# branches: P tile P (the serving shape; B * H = 160) and P / 2 (a lone
# prompt), P = N = 128 (jamba-1.5's head dim and d_state) with P tiles of
# 64 and of 128 (a warp holding 4 state items), N = 16 with a ragged L;
# phase 6c's training shape (mamba2-370m at B = 8, S = 512); last
# jamba-1.5's (128 heads of P = N = 128): phase 5g's prefill in bf16 (P
# tile 64, B * H = 512) and in f32 (its kernel-vs-naive fill: 16 heads a
# diagonal block, two carry blocks a head), and phase 6f's training shape;
# then the f32 instance's tiles: one chunk, 16 chunks (the carried state),
# B * H = 1, P and N not multiples of 4 at chunk 45, N = 256 at chunk 64;
# last the shapes the wrapper's plan reaches: mamba2's public chunk of 256
# (sub-chunks of 128) at mamba2-370m's widths in both dtypes, bf16 P = 48
# (P tile 16), N = 24 and P = 40 with N = 24 (padded to multiples of 16),
# N = 256 (sub-chunks of 64), the f32 (256, 256) block (sub-chunks of 64)
# and a chunk of 130 (sub-chunks of 65)
SSD_CASES = [(2, 128, 4, 32, 16, 32, "float32"),
             (1, 256, 2, 64, 128, 128, "float32"),
             (1, 64, 8, 64, 64, 32, "float32"),
             (2, 128, 2, 128, 128, 64, "float32"),
             (1, 128, 4, 32, 16, 32, "bfloat16"),
             (4, 512, 32, 64, 128, 128, "bfloat16"),
             (4, 512, 32, 64, 128, 128, "float32"),
             (4, 640, 32, 64, 128, 128, "bfloat16"),
             (4, 100, 32, 64, 128, 100, "bfloat16"),
             (2, 100, 4, 64, 128, 100, "float32"),
             (1, 128, 32, 64, 128, 128, "bfloat16"),
             (5, 256, 32, 64, 128, 128, "bfloat16"),
             (2, 256, 8, 128, 128, 128, "bfloat16"),
             (1, 128, 136, 128, 32, 64, "bfloat16"),
             (2, 128, 70, 128, 128, 64, "bfloat16"),
             (2, 100, 4, 32, 16, 100, "bfloat16"),
             (8, 512, 32, 64, 128, 128, "bfloat16"),
             (4, 512, 128, 128, 128, 128, "bfloat16"),
             (4, 512, 128, 128, 128, 128, "float32"),
             (8, 512, 128, 128, 128, 128, "bfloat16"),
             (1, 128, 4, 32, 16, 128, "float32"),
             (1, 2048, 2, 64, 128, 128, "float32"),
             (1, 256, 1, 64, 128, 128, "float32"),
             (1, 90, 2, 30, 18, 45, "float32"),
             (1, 128, 2, 32, 256, 64, "float32"),
             (4, 512, 32, 64, 128, 256, "bfloat16"),
             (2, 512, 8, 64, 128, 256, "float32"),
             (2, 256, 8, 48, 128, 128, "bfloat16"),
             (1, 128, 2, 32, 24, 64, "bfloat16"),
             (2, 256, 8, 40, 24, 64, "bfloat16"),
             (1, 128, 2, 64, 256, 128, "bfloat16"),
             (2, 256, 4, 64, 256, 128, "bfloat16"),
             (1, 256, 2, 256, 256, 128, "float32"),
             (1, 260, 4, 64, 128, 130, "bfloat16")]
# the one shape limit left, with the error's words: N past 256 state
# columns (in both dtypes)
SSD_REFUSED = [((1, 128, 2, 32, 512, 64), "256 state columns")]
SSD_CHUNK256 = (4, 512, 32, 64, 128, 256, "bfloat16")   # phase 8's row
SSD_MAIN = (4, 512, 32, 64, 128, 128, "bfloat16")
SSD_TRAIN = (8, 512, 32, 64, 128, 128, "bfloat16")      # phase 6c's
SSD_JAMBA = (4, 512, 128, 128, 128, 128, "bfloat16")    # phase 5g's
SSD_JAMBA_TRAIN = (8, 512, 128, 128, 128, 128, "bfloat16")   # 6f's


def ssd_inputs(b, s, h, p, n, dtype_name, seed):
    """The reference test's recipe, drawn on the card: x * softplus(dt)
    and B, C in ``dtype``, da = dt * A in f32 (A < 0)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype_name)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")
    x = normal(b, s, h, p)
    dt = torch.nn.functional.softplus(normal(b, s, h)).to(dtype).float()
    a = -torch.exp(0.5 * normal(h))
    xs = (x.to(dtype).float() * dt[..., None]).to(dtype)
    return xs, (dt * a).contiguous(), normal(b, s, n).to(dtype), \
        normal(b, s, n).to(dtype)


def ssd_compare(y, state, x, da, bm, cm, chunk) -> dict:
    """Kernel vs plain version within ``ref.allowed_error`` (the rule the
    card tests hold it to), with the count beyond the reference test's
    bare tolerance and both sides' distance from the exact (f64) value
    reported beside."""
    import torch
    from repro_torch.kernels.ssd_scan import ref
    y64, st64 = ref.ssd_reference(x.double(), da.double(), bm.double(),
                                  cm.double(), chunk)
    tol = ref.tolerance(x.dtype)
    out = {"tol": tol}
    for name, got, (want, allowed), exact in zip(
            ("y", "state"), (y, state),
            ref.allowed_error(x, da, bm, cm, chunk), (y64, st64)):
        got = got.double()
        err = (got - want).abs()
        out[name] = {
            "max_abs_err": float(err.max()),
            "beyond_plain_tol": int((err > tol + tol * want.abs()).sum()),
            "beyond_allowed": int((err > allowed).sum()),
            "kernel_vs_f64": float((got - exact).abs().max()),
            "plain_vs_f64": float((want - exact).abs().max()),
            "finite": bool(torch.isfinite(got).all())}
    return out


def ssd_vs_plain() -> dict:
    """Returns the largest |y - y_plain| of each case."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ops
    errs = {}
    limit, sms = kernel.max_smem(0), kernel.sm_count(0)
    for i, case in enumerate(SSD_CASES):
        b, s, h, p, n, chunk, dt = case
        x, da, bm, cm = ssd_inputs(b, s, h, p, n, dt, seed=100 + i)
        y, state = ops.ssd(x, da, bm, cm, chunk)
        torch.cuda.synchronize()
        res = ssd_compare(y, state, x, da, bm, cm, chunk)
        emit("kernel_vs_plain", kernel="ssd_scan", b=b, s=s, h=h, p=p, n=n,
             chunk=chunk, dtype=dt, plan=kernel.plan(
                 b, s, h, p, n, chunk, x.dtype, limit, sms)._asdict(), **res)
        for part in ("y", "state"):
            check(res[part]["finite"] and res[part]["beyond_allowed"] == 0,
                  f"ssd_scan {part} off at {case}: {res[part]}")
        errs[case] = res["y"]["max_abs_err"]
    # strongly negative da (exp above the diagonal would overflow to inf),
    # and da = 0 (every decay exactly 1)
    for shape, scale in (((1, 128, 4, 32, 16, "float32"), 200.0),
                         ((2, 256, 4, 64, 128, "bfloat16"), 200.0),
                         ((2, 256, 4, 64, 128, "float32"), 0.0)):
        x, da, bm, cm = ssd_inputs(*shape, seed=7)
        da = da * scale
        y, state = ops.ssd(x, da, bm, cm, 128)
        torch.cuda.synchronize()
        res = ssd_compare(y, state, x, da, bm, cm, 128)
        emit("kernel_vs_plain", kernel="ssd_scan", case=f"da*{scale:g}",
             dtype=shape[-1], **res)
        check(res["y"]["finite"] and res["state"]["finite"]
              and res["y"]["beyond_allowed"] == 0
              and res["state"]["beyond_allowed"] == 0,
              f"ssd_scan large-decay case {shape}: {res}")
    for ((b, s, h, p, n, chunk), words), dt in itertools.product(
            SSD_REFUSED, ("bfloat16", "float32")):
        before = ops.launches
        try:
            ops.ssd(*ssd_inputs(b, s, h, p, n, dt, seed=8), chunk)
            refused = ""
        except ValueError as e:
            refused = str(e)
        emit("kernel_refuses", kernel="ssd_scan", b=b, s=s, h=h, p=p, n=n,
             chunk=chunk, dtype=dt, error=refused)
        check(words in refused and ops.launches == before,
              f"ssd_scan {dt} did not refuse {(p, n, chunk)}: {refused!r}")
    return errs


# (b, s, h, kv, d, window, dtype name): the reference's kernel-test cases
# (MQA, windows 128 and 64, D 64/128/256, bf16), ragged S, then the
# training shape (qwen3-1.7b: 16 query and 8 KV heads of 128, B = 8,
# S = 512) in f32 and the config's bf16; then every branch of the bf16
# (tensor-core) instance: D 64, 128 and 256, GQA groups 1, 2 and 8,
# S = 17 and 300 (not multiples of its 64-row tiles) and 512, windows of
# 100 and 64 that start mid-tile; last the f32 (CUDA-core) instance's
# 128-row tiles: S = 1, 63, 65 and 1000, windows of 1, one key tile (64)
# and >= S, GQA groups of 1 and 8 at D = 64 and 256; last head dims no
# instance has, zero-padded to the next: D = 32 and 48 (the 5m preset's,
# at its training shape) on 64, 96 (Phi-3-mini's; bf16 at phase 8's row)
# on 128, 160 on 256, with a window and GQA groups
FLASH_CASES = [(1, 128, 4, 4, 64, 0, "float32"),
               (2, 256, 4, 2, 64, 0, "float32"),
               (1, 256, 8, 1, 64, 0, "float32"),
               (1, 128, 4, 4, 128, 0, "float32"),
               (1, 128, 2, 2, 256, 0, "float32"),
               (2, 256, 4, 2, 64, 128, "float32"),
               (1, 256, 4, 4, 64, 64, "float32"),
               (1, 128, 4, 2, 64, 0, "bfloat16"),
               (2, 300, 4, 2, 128, 0, "float32"),
               (2, 300, 4, 2, 64, 100, "bfloat16"),
               (8, 512, 16, 8, 128, 0, "float32"),
               (8, 512, 16, 8, 128, 0, "bfloat16"),
               (1, 17, 4, 4, 64, 0, "bfloat16"),
               (2, 17, 16, 2, 128, 0, "bfloat16"),
               (1, 17, 2, 1, 256, 0, "bfloat16"),
               (2, 300, 16, 2, 128, 0, "bfloat16"),
               (1, 300, 4, 2, 256, 0, "bfloat16"),
               (1, 512, 8, 1, 256, 0, "bfloat16"),
               (2, 512, 4, 4, 64, 0, "bfloat16"),
               (1, 512, 8, 4, 128, 100, "bfloat16"),
               (2, 300, 4, 4, 128, 64, "bfloat16"),
               (1, 512, 4, 2, 256, 64, "bfloat16"),
               (4, 512, 16, 8, 128, 0, "bfloat16"),
               (4, 515, 16, 8, 128, 0, "bfloat16"),
               (4, 512, 36, 36, 64, 0, "bfloat16"),
               (4, 512, 16, 16, 128, 0, "bfloat16"),
               (4, 515, 16, 16, 128, 0, "bfloat16"),
               (8, 512, 24, 24, 64, 0, "bfloat16"),
               (4, 512, 24, 24, 64, 0, "bfloat16"),
               (4, 515, 24, 24, 64, 0, "bfloat16"),
               (4, 768, 8, 1, 256, 0, "bfloat16"),
               (4, 512, 8, 1, 256, 0, "bfloat16"),
               (4, 515, 8, 1, 256, 0, "bfloat16"),
               (4, 512, 64, 8, 128, 0, "bfloat16"),
               (4, 512, 64, 8, 128, 0, "float32"),
               (4, 515, 64, 8, 128, 0, "bfloat16"),
               (8, 512, 64, 8, 128, 0, "bfloat16"),
               (2, 1, 4, 2, 128, 0, "float32"),
               (2, 63, 4, 2, 128, 0, "float32"),
               (2, 65, 4, 2, 128, 0, "float32"),
               (1, 1000, 4, 2, 128, 0, "float32"),
               (1, 300, 4, 2, 128, 1, "float32"),
               (1, 300, 4, 2, 128, 64, "float32"),
               (1, 300, 4, 2, 128, 512, "float32"),
               (2, 300, 4, 4, 64, 0, "float32"),
               (1, 300, 8, 1, 64, 0, "float32"),
               (1, 300, 8, 1, 256, 64, "float32"),
               (1, 64, 2, 2, 32, 0, "float32"),
               (4, 256, 4, 4, 48, 0, "float32"),
               (2, 300, 4, 2, 48, 100, "bfloat16"),
               (1, 300, 8, 2, 96, 0, "float32"),
               (8, 512, 32, 32, 96, 0, "bfloat16"),
               (1, 200, 4, 4, 160, 64, "float32"),
               (1, 256, 8, 1, 160, 0, "bfloat16")]
# head dims past the largest instance (256), refused in both dtypes
FLASH_REFUSED = [((1, 64, 2, 2, 512), "largest instance, 256")]
# the same fields, causal=False: the bf16 instance without the causal
# bound, ragged, and with a window that starts mid-tile; then the f32
# instance the same ways
FLASH_NON_CAUSAL = [(1, 300, 4, 2, 128, 0, "bfloat16"),
                    (2, 17, 8, 1, 64, 0, "bfloat16"),
                    (1, 300, 4, 1, 64, 100, "bfloat16"),
                    (1, 300, 4, 2, 128, 0, "float32"),
                    (2, 200, 4, 1, 64, 100, "float32")]
FLASH_MAIN = (8, 512, 16, 8, 128, 0, "bfloat16")
# phase 9b's --preset 5m training (4 edges' B = 4, S = 256, 4 heads of 48,
# f32) and a bf16 head dim of 96 (8, 512, 32, 32, 96): phase 8's rows of
# padded head dims
FLASH_5M = (4, 256, 4, 4, 48, 0, "float32")
FLASH_D96 = (8, 512, 32, 32, 96, 0, "bfloat16")
# phase 5b's prefill (qwen3-1.7b serving, 4 slots: a full wave, and a
# mid-flight admission at a ragged 515 above), phase 6b's attention
# (minicpm-2b: 36 heads of 64, MHA, B = 4) and phases 5c / 5d's prefill
# (olmoe-1b-7b and deepseek-moe-16b: 16 heads of 128, MHA, 4 slots; a
# ragged 515 above); phase 6d's and 5e's (musicgen-medium: 24 heads of 64,
# MHA; training at B = 8, a prefill of 4 slots), phase 6e's and 5f's prefix
# prefill (paligemma-3b: 8 query heads of 256, 1 KV head, 256 prefix
# embeddings before 512 tokens) and 5f's engine prefill of text prompts;
# each with its own row in the kernels line
FLASH_SERVE = (4, 512, 16, 8, 128, 0, "bfloat16")
FLASH_MINICPM = (4, 512, 36, 36, 64, 0, "bfloat16")
FLASH_MOE = (4, 512, 16, 16, 128, 0, "bfloat16")
FLASH_MUSICGEN = (8, 512, 24, 24, 64, 0, "bfloat16")
FLASH_MUSICGEN_SERVE = (4, 512, 24, 24, 64, 0, "bfloat16")
FLASH_PALIGEMMA = (4, 768, 8, 1, 256, 0, "bfloat16")
FLASH_PALIGEMMA_SERVE = (4, 512, 8, 1, 256, 0, "bfloat16")
# jamba-1.5's attention layer (64 query heads over 8 KV heads of 128, a
# group of 8): phase 5g's prefill (4 slots; a ragged 515 above) and 6f's
# training (B = 8); then phase 5h's long-context prefill (qwen3-1.7b, 2
# slots of 12,288 tokens, the sliding window of 8192: the kernel's window
# branch, which skips the tiles wholly before each query tile's window),
# compared with its plain version one KV head's group at a time (the
# whole plain version's f64 logits would take 38.7 GB)
FLASH_JAMBA = (4, 512, 64, 8, 128, 0, "bfloat16")
FLASH_JAMBA_TRAIN = (8, 512, 64, 8, 128, 0, "bfloat16")
FLASH_LONG = (2, 12288, 16, 8, 128, 8192, "bfloat16")


def flash_inputs(b, s, h, kv, d, dtype_name, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dtype = getattr(torch, dtype_name)
    return [torch.randn(*shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def flash_vs_plain() -> dict:
    """Every case within ``ref.allowed_error`` (the rule the card tests
    hold the kernel to: the reference test's bare tolerance); returns the
    largest |o - o_plain| of each causal case."""
    import torch
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    errs = {}
    cases = [(c, True) for c in FLASH_CASES] + \
        [(c, False) for c in FLASH_NON_CAUSAL]
    for i, (case, causal) in enumerate(cases):
        b, s, h, kv, d, window, dt = case
        q, k, v = flash_inputs(b, s, h, kv, d, dt, seed=200 + i)
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want, allowed = ref.allowed_error(q, k, v, causal=causal,
                                          window=window)
        exact = ref.attention_ref(q.double(), k.double(), v.double(),
                                  causal=causal, window=window).double()
        err = (out.double() - want).abs()
        res = {"max_abs_err": float(err.max()),
               "beyond_allowed": int((err > allowed).sum()),
               "kernel_vs_f64": float((out.double() - exact).abs().max()),
               "plain_vs_f64": float((want - exact).abs().max()),
               "finite": bool(torch.isfinite(out).all())}
        emit("kernel_vs_plain", kernel="flash_attention", b=b, s=s, h=h,
             kv=kv, d=d, instance_d=kernel.padded_head_dim(d), window=window,
             causal=causal, dtype=dt, tol=ref.tolerance(q.dtype), **res)
        check(res["finite"] and res["beyond_allowed"] == 0,
              f"flash_attention off at {case}, causal={causal}: {res}")
        if causal:
            errs[case] = res["max_abs_err"]
    for ((b, s, h, kv, d), words), dt in itertools.product(
            FLASH_REFUSED, ("bfloat16", "float32")):
        before = ops.launches
        try:
            ops.flash_attention(*flash_inputs(b, s, h, kv, d, dt, seed=9))
            refused = ""
        except ValueError as e:
            refused = str(e)
        emit("kernel_refuses", kernel="flash_attention", b=b, s=s, h=h,
             kv=kv, d=d, dtype=dt, error=refused)
        check(words in refused and ops.launches == before,
              f"flash_attention {dt} did not refuse D={d}: {refused!r}")
    errs[FLASH_LONG] = flash_long_vs_plain(FLASH_LONG)
    return errs


def flash_long_vs_plain(case) -> float:
    """``case``'s kernel output against the plain version within
    ``ref.allowed_error``, held one (batch row, KV head) at a time: each
    query head sees only its own KV head, so a slice of q's heads and of
    k and v is the whole function on that slice."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    b, s, h, kv, d, window, dt = case
    q, k, v = flash_inputs(b, s, h, kv, d, dt, seed=299)
    out = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    g = h // kv
    res = {"max_abs_err": 0.0, "beyond_allowed": 0, "kernel_vs_f64": 0.0,
           "plain_vs_f64": 0.0, "finite": bool(torch.isfinite(out).all())}
    for i in range(b):
        for j in range(kv):
            qs = q[i:i + 1, :, j * g:(j + 1) * g]
            ks, vs = k[i:i + 1, :, j:j + 1], v[i:i + 1, :, j:j + 1]
            got = out[i:i + 1, :, j * g:(j + 1) * g].double()
            want, allowed = ref.allowed_error(qs, ks, vs, window=window)
            exact = ref.attention_ref(qs.double(), ks.double(), vs.double(),
                                      window=window)
            err = (got - want).abs()
            res["max_abs_err"] = max(res["max_abs_err"], float(err.max()))
            res["beyond_allowed"] += int((err > allowed).sum())
            res["kernel_vs_f64"] = max(res["kernel_vs_f64"], float(
                (got - exact).abs().max()))
            res["plain_vs_f64"] = max(res["plain_vs_f64"], float(
                (want - exact).abs().max()))
            del want, allowed, exact, err
    emit("kernel_vs_plain", kernel="flash_attention", b=b, s=s, h=h, kv=kv,
         d=d, window=window, causal=True, dtype=dt,
         tol=ref.tolerance(q.dtype), compared="per (batch row, KV head)",
         **res)
    check(res["finite"] and res["beyond_allowed"] == 0,
          f"flash_attention off at {case}: {res}")
    del q, k, v, out
    torch.cuda.empty_cache()
    return res["max_abs_err"]


# -- phase 4: the slice ----------------------------------------------------------

def f1_flip_bound(y) -> float:
    """Largest macro-F1 change one flipped prediction can make: it moves
    one unit of tp/fp/fn in two classes, each class's F1 by at most
    2 / support."""
    import numpy as np
    support = np.bincount(y)
    return 4.0 / (len(support) * float(support.min()))


def run_session(fx, mode: str, init):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                              utility=fx["utility"])
    sess = (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))
    t0 = time.perf_counter()
    rep = sess.run()
    return rep, time.perf_counter() - t0


def decisions(rep):
    return [(r.interval, r.edge) for r in rep.records]


def slice_phase() -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.classic import classic_fixture

    gpu = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                          device="cuda")
    check(gpu["model"].impl == "cuda", "kmeans on CUDA must use the kernel")
    init = params_to_numpy(gpu["init_params"])

    # the main path: every kernel count is read around exactly this run
    ops.launches = 0
    ssd_ops.launches = 0
    fa_ops.launches = 0
    gpu_reports, per_mode = {}, {}
    for mode in ("sync", "async"):
        before = ops.launches
        rep, secs = run_session(gpu, mode, params_from_numpy(init, "cuda"))
        torch.cuda.synchronize()
        gpu_reports[mode] = (rep, secs)
        per_mode[mode] = ops.launches - before
        check(per_mode[mode] > 0, f"kmeans {mode}: kernel never launched")
    launches = ops.launches
    check(ssd_ops.launches == 0 and fa_ops.launches == 0,
          "the EL loop launched ssd_scan or flash_attention")

    cpu = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                          device="cpu")
    bound = f1_flip_bound(cpu["executor"].eval_set["y"].numpy())
    for mode in ("sync", "async"):
        rep, secs = gpu_reports[mode]
        ref, ref_secs = run_session(cpu, mode, params_from_numpy(init, "cpu"))
        same = decisions(rep) == decisions(ref)
        emit("slice", arch="kmeans-traffic", mode=mode, device="cuda",
             aggregations=rep.n_aggregations,
             consumed=rep.total_consumed, final_f1=rep.final_metric,
             arm_pulls=rep.arm_pulls, reason=rep.terminated_reason,
             run_s=secs, kernel_launches=per_mode[mode],
             cpu_final_f1=ref.final_metric, cpu_run_s=ref_secs,
             same_decisions=same, f1_flip_bound=bound)
        check(same, f"kmeans {mode}: CUDA and CPU decisions differ")
        check(rep.arm_pulls == ref.arm_pulls, f"kmeans {mode}: arm pulls")
        check(abs(rep.final_metric - ref.final_metric) <= bound,
              f"kmeans {mode}: final F1 {rep.final_metric} vs CPU "
              f"{ref.final_metric}")
        check(math.isfinite(rep.final_metric) and
              all(torch.isfinite(v).all() for v in rep.final_params.values()),
              f"kmeans {mode}: non-finite result")

    svm = classic_fixture("svm-wafer", samples=20000, n_edges=4,
                          device="cuda")
    rep, secs = run_session(svm, "sync", svm["init_params"])
    torch.cuda.synchronize()
    emit("slice", arch="svm-wafer", mode="sync", device="cuda",
         aggregations=rep.n_aggregations, consumed=rep.total_consumed,
         final_accuracy=rep.final_metric, arm_pulls=rep.arm_pulls,
         reason=rep.terminated_reason, run_s=secs)
    check(rep.n_aggregations > 0 and 0.5 < rep.final_metric <= 1.0,
          f"svm-wafer sync: accuracy {rep.final_metric}")
    host_s = {"kmeans-traffic": gpu_reports["sync"][1], "svm-wafer": secs}
    return {"kmeans_assign": launches}, host_s


# -- phase 4b: the compiled sync round ---------------------------------------------

COMPILED_ROUNDS = 512             # run_sync_ingraph's default horizon


def compiled_session(fx, init):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="sync", n_edges=4,
                              utility=fx["utility"])
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def replay_draws(cfg, batch, seed):
    """The compiled round's draws for every round of the horizon from a
    seeded CPU generator (numpy), handed to both devices alike."""
    import numpy as np
    from repro_torch.el.rng import ReplayDraws
    rng = np.random.default_rng(seed)
    k, e = cfg.max_interval, cfg.n_edges
    return ReplayDraws(rng.gumbel(size=(COMPILED_ROUNDS, k)),
                       rng.uniform(size=(COMPILED_ROUNDS, e, k, batch)),
                       rng.standard_normal((COMPILED_ROUNDS, e)))


def flip_bound(arch, y) -> float:
    return f1_flip_bound(y) if arch == "kmeans-traffic" else 1.0 / len(y)


def classic_fixtures() -> dict:
    from repro_torch.launch.classic import classic_fixture
    return {arch: {dev: classic_fixture(arch, samples=20000, n_edges=4,
                                        device=dev)
                   for dev in ("cuda", "cpu")}
            for arch in ("kmeans-traffic", "svm-wafer")}


def compiled_phase(host_s: dict, fixtures) -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops

    # (a) replayed draws: the card's decisions are the CPU run's
    for arch, fx in fixtures.items():
        init = params_to_numpy(fx["cuda"]["init_params"])
        reps = {}
        for dev in ("cuda", "cpu"):
            sess = compiled_session(fx[dev], params_from_numpy(init, dev))
            draws = replay_draws(sess.cfg, fx[dev]["executor"].batch, seed=3)
            reps[dev] = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS,
                                              draws=draws)
        gpu, cpu = reps["cuda"], reps["cpu"]
        bound = flip_bound(arch, fx["cpu"]["executor"].eval_set["y"].numpy())
        same = [r.interval for r in gpu.records] == \
            [r.interval for r in cpu.records]
        emit("compiled_vs_cpu", arch=arch, draws="replayed (numpy seed 3)",
             rounds=gpu.n_aggregations, cpu_rounds=cpu.n_aggregations,
             same_intervals=same, arm_pulls=gpu.arm_pulls,
             cpu_arm_pulls=cpu.arm_pulls, reason=gpu.terminated_reason,
             final_metric=gpu.final_metric, cpu_final_metric=cpu.final_metric,
             flip_bound=bound, consumed=gpu.total_consumed,
             cpu_consumed=cpu.total_consumed,
             device_loop=gpu.telemetry["device_loop"])
        check(same, f"compiled {arch}: card and CPU intervals differ")
        check(gpu.arm_pulls == cpu.arm_pulls and gpu.terminated_reason ==
              cpu.terminated_reason, f"compiled {arch}: arm pulls or end")
        check(abs(gpu.final_metric - cpu.final_metric) <= bound,
              f"compiled {arch}: final metric {gpu.final_metric} vs CPU "
              f"{cpu.final_metric}")

    # (b) the card's own generator: the main path, counts read around it
    result = {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, fx in fixtures.items():
        sess = compiled_session(fx["cuda"], fx["cuda"]["init_params"])
        runs = []
        for _ in range(2):             # the first run captures the graph
            before = ops.batched_launches
            t0 = time.perf_counter()
            rep = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            loop = rep.telemetry["device_loop"]
            runs.append({"run_s": secs, "rounds": rep.n_aggregations,
                         "kernel_launches": ops.batched_launches - before,
                         "reason": rep.terminated_reason,
                         "final_metric": rep.final_metric,
                         "arm_pulls": rep.arm_pulls, **loop})
            check(rep.terminated_reason == "budget_exhausted"
                  and rep.n_aggregations > 0
                  and math.isfinite(rep.final_metric)
                  and all(bool(torch.isfinite(v).all())
                          for v in rep.final_params.values()),
                  f"compiled {arch}: {rep.summary()}")
        emit("compiled", arch=arch, device="cuda", draws="torch.Generator "
             "on the card, seed cfg.seed + 17", runs=runs,
             host_loop_run_s=host_s[arch])
        check(runs[0]["graphs_captured"] == 1 and
              runs[1]["graphs_captured"] == 0 and
              all(r["replays"] == r["chunks"] > 0 for r in runs),
              f"compiled {arch}: graphs / replays {runs}")
        result[arch] = runs
    launches = counts()
    km = result["kmeans-traffic"]
    check(launches["kmeans_assign_batched"] > 0 and
          launches["kmeans_assign_batched"] == sum(
              r["kernel_launches"] for r in km),
          f"compiled kmeans: batched kmeans_assign launches {launches}")
    # the single entry runs once per kmeans run: the report's final F1
    # (``ex.evaluate``'s E-step over the evaluation set)
    check(launches["kmeans_assign"] == len(km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"compiled: unexpected kernel launches {launches}")
    return {"kmeans_assign_batched": launches["kmeans_assign_batched"],
            "runs": result}


# -- phase 4c: the compiled async event engine ---------------------------------------

ASYNC_EVENTS = 512                # the full-width runs' padded horizon (336)
ASYNC_WAVE = 4                    # the pinned wave width, all four edges


def async_session(fx, init, batch_k):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode="async", n_edges=4,
                              utility=fx["utility"], async_batch_k=batch_k)
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def async_replay_draws(cfg, batch, seed):
    """Every edge's draws for every event of the horizon, and the initial
    round's, from a seeded CPU generator (numpy), handed to both devices
    alike."""
    import numpy as np
    from repro_torch.el.rng import ReplayDraws
    rng = np.random.default_rng(seed)
    k, e = cfg.max_interval, cfg.n_edges
    return ReplayDraws(rng.gumbel(size=(ASYNC_EVENTS, e, k)),
                       rng.uniform(size=(ASYNC_EVENTS, e, k, batch)),
                       rng.standard_normal((ASYNC_EVENTS, e)),
                       init_gumbel=rng.gumbel(size=(e, k)),
                       init_normal=rng.standard_normal(e))


def event_decisions(rep):
    """Event order, intervals, charged totals and event times: at fixed
    cost the same bits on every device."""
    return [(r.edge, r.interval, r.total_consumed, r.wall_time)
            for r in rep.records]


def event_records(rep) -> list:
    """An async run's events, every field: edge, interval, charged total,
    time, metric, utility."""
    return [[r.edge, r.interval, r.total_consumed, r.wall_time, r.metric,
             r.utility] for r in rep.records]


def max_param_diff(a, b) -> float:
    return max(float((a[k].float().cpu() - b[k].float().cpu()).abs().max())
               for k in a)


def async_phase(fixtures) -> dict:
    import math
    import torch
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops

    # (a) replayed draws: the card's decisions are the CPU run's, and a
    # K-event wave's the single events'; the card runs' events and params
    # are phase 11's unsharded references
    replayed = {}
    for arch, fx in fixtures.items():
        init = params_to_numpy(fx["cuda"]["init_params"])
        reps = {}
        for dev, bk in (("cuda", 1), ("cpu", 1), ("cuda", ASYNC_WAVE)):
            sess = async_session(fx[dev], params_from_numpy(init, dev), bk)
            draws = async_replay_draws(sess.cfg, fx[dev]["executor"].batch,
                                       seed=5)
            reps[dev, bk] = sess.run_async_ingraph(draws=draws)
        gpu, cpu, wave = reps["cuda", 1], reps["cpu", 1], \
            reps["cuda", ASYNC_WAVE]
        replayed[arch] = {"init": init, **{
            bk: {"events": event_records(reps["cuda", bk]),
                 "digest": tree_digest(reps["cuda", bk].final_params)}
            for bk in (1, ASYNC_WAVE)}}
        bound = flip_bound(arch, fx["cpu"]["executor"].eval_set["y"].numpy())
        same = event_decisions(gpu) == event_decisions(cpu)
        same_wave = event_decisions(wave) == event_decisions(gpu)
        emit("async_vs_cpu", arch=arch, draws="replayed (numpy seed 5)",
             events=gpu.n_aggregations, cpu_events=cpu.n_aggregations,
             wave_events=wave.n_aggregations, same_decisions=same,
             wave_same_decisions=same_wave, arm_pulls=gpu.arm_pulls,
             cpu_arm_pulls=cpu.arm_pulls, wave_arm_pulls=wave.arm_pulls,
             reason=gpu.terminated_reason, consumed=gpu.total_consumed,
             cpu_consumed=cpu.total_consumed, wall=gpu.wall_time,
             cpu_wall=cpu.wall_time, final_metric=gpu.final_metric,
             cpu_final_metric=cpu.final_metric,
             wave_final_metric=wave.final_metric, flip_bound=bound,
             wave_max_param_diff=max_param_diff(wave.final_params,
                                                gpu.final_params),
             device_loop=gpu.telemetry["device_loop"],
             wave_device_loop=wave.telemetry["device_loop"])
        check(same, f"async {arch}: card and CPU events differ")
        check(same_wave, f"async {arch}: batch_k={ASYNC_WAVE} and "
              "batch_k=1 events differ on the card")
        for other in (cpu, wave):
            check(other.arm_pulls == gpu.arm_pulls and
                  other.terminated_reason == gpu.terminated_reason ==
                  "budget_exhausted", f"async {arch}: arm pulls or end")
            check(abs(other.final_metric - gpu.final_metric) <= bound,
                  f"async {arch}: final metric {other.final_metric} vs "
                  f"{gpu.final_metric}")

    # the yardstick: the host event loop on numpy streams, on the card
    host_s = {}
    for arch, fx in fixtures.items():
        sess = async_session(fx["cuda"], fx["cuda"]["init_params"], 1)
        t0 = time.perf_counter()
        rep = sess.run_async()
        torch.cuda.synchronize()
        host_s[arch] = {"run_s": time.perf_counter() - t0,
                        "events": rep.n_aggregations}

    # (b) the card's own generator: the main path, counts read around it
    result = {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, fx in fixtures.items():
        for bk in (1, ASYNC_WAVE):
            sess = async_session(fx["cuda"], fx["cuda"]["init_params"], bk)
            runs = []
            for _ in range(2):         # the first run captures the graph
                before = ops.batched_launches
                t0 = time.perf_counter()
                rep = sess.run_async_ingraph()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                loop = rep.telemetry["device_loop"]
                runs.append({"run_s": secs, "events": rep.n_aggregations,
                             "kernel_launches": ops.batched_launches - before,
                             "reason": rep.terminated_reason,
                             "final_metric": rep.final_metric,
                             "arm_pulls": rep.arm_pulls, **loop})
                check(rep.terminated_reason == "budget_exhausted"
                      and rep.n_aggregations > 0
                      and all(bool(torch.isfinite(v).all())
                              for v in rep.final_params.values())
                      and math.isfinite(rep.final_metric),
                      f"async {arch} batch_k={bk}: {rep.summary()}")
            emit("async", arch=arch, device="cuda", batch_k=bk,
                 draws="torch.Generator on the card, seed cfg.seed + 17",
                 runs=runs, host_run_async=host_s[arch])
            check(runs[0]["graphs_captured"] == 1 and
                  runs[1]["graphs_captured"] == 0 and
                  all(r["replays"] == r["chunks"] > 0 for r in runs),
                  f"async {arch} batch_k={bk}: graphs / replays {runs}")
            check(runs[0]["events"] == runs[1]["events"] and
                  runs[0]["arm_pulls"] == runs[1]["arm_pulls"],
                  f"async {arch} batch_k={bk}: the two runs differ")
            if arch == "kmeans-traffic":
                for r in runs:
                    # every local step of every step, masked or not; the
                    # capture's warm-up chunk runs eagerly
                    per_graph = r["rounds_per_chunk"] * 10
                    check(r["kernel_launches_per_graph"] == per_graph and
                          r["kernel_launches"] == per_graph * (
                              r["replays"] + r["graphs_captured"]),
                          f"async kmeans batch_k={bk}: launches {r}")
            result[arch, bk] = runs
    launches = counts()
    km = result["kmeans-traffic", 1] + result["kmeans-traffic", ASYNC_WAVE]
    check(launches["kmeans_assign_batched"] == sum(
              r["kernel_launches"] for r in km) > 0,
          f"async kmeans: batched kmeans_assign launches {launches}")
    # the single entry runs once per kmeans run: the report's final F1
    check(launches["kmeans_assign"] == len(km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"async: unexpected kernel launches {launches}")
    return {"kmeans_assign": launches["kmeans_assign"],
            "kmeans_assign_batched": launches["kmeans_assign_batched"],
            "replayed": replayed}


# -- phase 4d: the compiled ablation sweep ------------------------------------

# the paper's Figs. 3-5 grids at the phases' full width: 24 sync cells and
# two async sub-sweeps (one per wave width) of 8
SWEEP_SYNC = {"ucb_c": (0.5, 1.0, 2.0), "budget": (2500.0, 5000.0),
              "heterogeneity": (1.0, 6.0), "seeds": (0, 1),
              "max_rounds": 256}
SWEEP_ASYNC = {"async_batch_k": (1, ASYNC_WAVE), "ucb_c": (1.0, 2.0),
               "budget": (2500.0, 5000.0), "seeds": (0, 1)}
# functorch's warning when an op has no batching rule and runs once per
# cell: on the sweep's path it is an error
PERF_DROP = ".*performance drop.*"
SWEEP_CELLS = 24                  # the sync grid's cells: 96 (cell, edge)


class FillClock:
    """Host seconds spent in ``CellDraws.fill`` (the per-cell draw
    refill before each chunk)."""

    def __init__(self):
        from repro_torch.el.rng import CellDraws
        self.cls, self.orig, self.seconds, self.calls = \
            CellDraws, CellDraws.fill, 0.0, 0
        clock = self

        def timed(draws, *a, **kw):
            t0 = time.perf_counter()
            clock.orig(draws, *a, **kw)
            clock.seconds += time.perf_counter() - t0
            clock.calls += 1
        CellDraws.fill = timed

    def close(self):
        self.cls.fill = self.orig


def sweep_grid(sess, mode):
    """The mode's grid (``SWEEP_SYNC`` / ``SWEEP_ASYNC``, the async one's
    horizon its top budget's padded event horizon)."""
    from repro_torch.el.events import padded_event_horizon
    from repro_torch.el.sweep import SweepSpec
    if mode == "sync":
        return SweepSpec(**SWEEP_SYNC)
    top = dataclasses.replace(sess.cfg, budget=max(SWEEP_ASYNC["budget"]))
    return SweepSpec(**SWEEP_ASYNC, max_rounds=padded_event_horizon(top))


def sweep_session(fx, mode):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                              utility=fx["utility"])
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))


def cell_report(rep, i, horizon, mode):
    """Cell ``i`` of a sweep as the ``ELReport`` a solo run gives."""
    from repro_torch.el.report import report_from_out
    out = {k: v[i] for k, v in rep.out.items() if k != "final_metric_host"}
    return report_from_out(out, mode=mode, policy=rep.policy,
                           horizon=horizon, final_metric=float("nan"),
                           final_params=None, elapsed_s=0.0)


def out_digest(out: dict) -> dict:
    """A SHA-1 of each array's dtype, shape and bytes (nested dicts
    through)."""
    import hashlib
    import numpy as np
    if isinstance(out, dict):
        return {k: out_digest(v) for k, v in out.items()}
    a = np.ascontiguousarray(out)
    return hashlib.sha1(f"{a.dtype}{a.shape}".encode()
                        + a.tobytes()).hexdigest()


def sweep_digest(rep) -> dict:
    """A sweep's every cell, bit for bit: its ``out`` and final params."""
    return {"out": out_digest(rep.out),
            "params": tree_digest(rep.final_params)}


def max_diff(a, b) -> float:
    """The largest |a - b| where both are finite (0 where none is)."""
    import numpy as np
    a, b = np.float32(a), np.float32(b)
    ok = np.isfinite(a) & np.isfinite(b)
    check(bool((np.isfinite(a) == np.isfinite(b)).all()),
          "a metric is finite on one side only")
    return float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0


def sync_margin(sess_cfg, rep) -> float:
    """The smallest top-2 margin of ``logits + g`` over a sync run's
    rounds, its bandit rebuilt from the records and its Gumbel draws
    regenerated from the cell's seed (item t's draws depend on t only)."""
    import torch
    from repro_torch.core import bandit
    from repro_torch.el.ingraph import sync_knobs
    from repro_torch.el.rng import TorchDraws
    n, k, e = rep.n_aggregations, sess_cfg.max_interval, sess_cfg.n_edges
    dev = torch.device("cuda")
    bufs = {"gumbel": torch.zeros(n, k, device=dev),
            "uniform": torch.zeros(n, e, k, 1, device=dev),
            "normal": torch.zeros(n, e, device=dev)}
    TorchDraws(torch.Generator(device=dev).manual_seed(
        sess_cfg.seed + 17)).fill(bufs, 0)
    knobs = {name: torch.as_tensor(v, device=dev)
             for name, v in sync_knobs(sess_cfg).items()}
    state = bandit.device_bandit_init(k, dev)
    wall, best = torch.zeros((), device=dev), float("inf")
    for t, r in enumerate(rep.records):
        w = bandit.device_selection_weights(state, knobs["budget"] - wall,
                                            knobs["costs_k"], knobs["ucb_c"])
        top2 = (bandit.device_arm_logits(w) + bufs["gumbel"][t]).topk(2)
        best = min(best, float(top2.values[0] - top2.values[1]))
        state = bandit.device_bandit_update(
            state, torch.tensor(int(r.interval) - 1, device=dev),
            torch.tensor(r.utility, dtype=torch.float32, device=dev),
            torch.zeros((), device=dev))
        wall = torch.tensor(r.wall_time, dtype=torch.float32, device=dev)
    return best


def sweep_phase(fixtures) -> dict:
    import warnings
    import numpy as np
    import torch
    from repro_torch.kernels.kmeans_assign import ops

    warnings.filterwarnings("error", message=PERF_DROP)
    card = card_line()
    sessions, specs = {}, {}
    for arch, fx in fixtures.items():
        for mode in ("sync", "async"):
            sess = sweep_session(fx["cuda"], mode)
            sessions[arch, mode], specs[arch, mode] = sess, sweep_grid(
                sess, mode)

    # (a) the main path, counts read around it: each grid twice, the
    # first run capturing its graphs, the second reusing them
    reports, runs = {}, {}
    clock = FillClock()
    reset_counts()
    torch.cuda.synchronize()
    for key, sess in sessions.items():
        runs[key] = []
        for _ in range(2):
            before, fills = ops.batched_launches, clock.seconds
            t0 = time.perf_counter()
            rep = sess.sweep(specs[key])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            loops = rep.telemetry["device_loops"]
            chunks = sum(lp["chunks"] for lp in loops)
            runs[key].append({
                "run_s": secs, "cells": rep.n_cells, "chunks": chunks,
                "replays": sum(lp["replays"] for lp in loops),
                "graphs_captured": sum(lp["graphs_captured"] for lp in loops),
                "kernel_launches": ops.batched_launches - before,
                "device_loops": loops,
                "fill_ms_per_chunk": 1e3 * (clock.seconds - fills) / chunks,
                "rounds": [int(n) for n in rep.out["n_rounds"]]})
        reports[key] = rep
    launches = counts()
    clock.close()
    warnings.filterwarnings("default", message=PERF_DROP)

    for (arch, mode), rs in runs.items():
        rep, spec = reports[arch, mode], specs[arch, mode]
        check(rs[0]["graphs_captured"] == len(rep.telemetry["device_loops"])
              and rs[1]["graphs_captured"] == 0
              and all(r["replays"] == r["chunks"] > 0 for r in rs),
              f"sweep {arch} {mode}: graphs / replays {rs}")
        check(not rep.truncated().any(),
              f"sweep {arch} {mode}: truncated cells {rep.truncated()}")
        finals = rep.final_metrics()
        check(np.isfinite(finals).all() and all(
            bool(torch.isfinite(v).all())
            for v in rep.final_params.values()),
            f"sweep {arch} {mode}: final metrics {finals}")
        if arch == "kmeans-traffic":
            for r in rs:
                for lp in r["device_loops"]:
                    # one launch a local step for every (cell, edge) pair:
                    # rounds_per_chunk x k a graph, not x C
                    check(lp["kernel_launches_per_graph"] ==
                          lp["rounds_per_chunk"] * 10,
                          f"sweep kmeans {mode}: launches per graph {lp}")
                check(r["kernel_launches"] == 160 * (
                    r["replays"] + r["graphs_captured"]),
                    f"sweep kmeans {mode}: batched launches {r}")
    km = [r for (arch, _), rs in runs.items() if arch == "kmeans-traffic"
          for r in rs]
    check(launches["kmeans_assign_batched"] == sum(
        r["kernel_launches"] for r in km) > 0,
        f"sweep: batched kmeans_assign launches {launches}")
    # the single entry scores each kmeans cell's final params (F1)
    check(launches["kmeans_assign"] == sum(r["cells"] for r in km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"sweep: unexpected kernel launches {launches}")

    # (b) every cell against a solo run of its config on the card's
    # default draws; the solo runs share one program per mode (and wave
    # width), the first capturing it
    for (arch, mode), rep in reports.items():
        sess, spec = sessions[arch, mode], specs[arch, mode]
        solo = sweep_session(fixtures[arch]["cuda"], mode)
        cfgs = spec.cell_cfgs(sess.cfg)
        solo_s, diffs, margin = 0.0, [0.0, 0.0], float("inf")
        for i, ccfg in enumerate(cfgs):
            solo.cfg = ccfg
            run = (lambda: solo.run_sync_ingraph(max_rounds=spec.max_rounds)
                   ) if mode == "sync" else solo.run_async_ingraph
            if i == 0 or (mode == "async" and ccfg.async_batch_k !=
                          cfgs[i - 1].async_batch_k):
                run()                          # capture the solo graph
            t0 = time.perf_counter()
            ind = run()
            torch.cuda.synchronize()
            solo_s += time.perf_counter() - t0
            cell = cell_report(rep, i, spec.max_rounds, mode)
            # (edge, interval, consumed, wall) a round or event, bits
            same = event_decisions(cell) == event_decisions(ind)
            check(same and cell.arm_pulls == ind.arm_pulls and
                  cell.terminated_reason == ind.terminated_reason ==
                  "budget_exhausted",
                  f"sweep {arch} {mode} cell {i} ({spec.cells(sess.cfg)[i]}):"
                  f" {cell.n_aggregations} rounds vs the solo run's "
                  f"{ind.n_aggregations}")
            for j, f in enumerate(("metric", "utility")):
                diffs[j] = max(diffs[j], max_diff(
                    [getattr(r, f) for r in cell.records],
                    [getattr(r, f) for r in ind.records]))
            if mode == "sync":
                margin = min(margin, sync_margin(ccfg, ind))
        waves = {}
        if mode == "async":
            # async_batch_k is slowest: the K = 4 cells are the K = 1
            # cells' twins, in order
            half = rep.n_cells // 2
            waves = {"wave_same_decisions": all(
                event_decisions(cell_report(rep, i, spec.max_rounds, mode))
                == event_decisions(cell_report(rep, half + i,
                                               spec.max_rounds, mode))
                for i in range(half))}
            check(waves["wave_same_decisions"],
                  f"sweep {arch}: batch_k={ASYNC_WAVE} cells differ from "
                  "their batch_k=1 twins")
        emit("sweep", arch=arch, mode=mode, device="cuda",
             draws="torch.Generator per cell on the card, seed + 17",
             spec=spec.describe(sess.cfg), runs=runs[arch, mode],
             solo_runs_s=solo_s, same_decisions_as_solo=True,
             max_metric_diff=diffs[0], max_utility_diff=diffs[1],
             min_top2_margin=margin if mode == "sync" else "not measured",
             final_metrics=[float(m) for m in rep.final_metrics()],
             card=card, **waves)
    return {"kmeans_assign": launches["kmeans_assign"],
            "kmeans_assign_batched": launches["kmeans_assign_batched"],
            "digests": {key: dict(sweep_digest(rep),
                                  run_s=runs[key][1]["run_s"])
                        for key, rep in reports.items()}}


# -- phase 4e: the scenario engine ---------------------------------------------

# one scenario with all three parts, at fixed cost: 20 % dropout on a
# 32-round schedule, Pareto(2) straggler spikes on a 64-round one, drift
SCN_POLICIES = ("ol4el", "task_alloc", "delay_energy")
# the churn benchmark's grid (benchmarks/churn_baselines.py): 3 policies x
# churn rates x seeds, heterogeneity 6, churn period 32, 256 rounds; on
# svm-wafer with its data (4,000 samples, 3 edges, budget 1200, lr 0.01,
# batch 32), and on kmeans-traffic at the phases' full width
CHURN_RATES, CHURN_SEEDS = (0.0, 0.2, 0.4), (0, 1, 2)
CHURN_GRID = {"heterogeneity": 6.0, "period": 32, "max_rounds": 256}
CHURN_SVM = {"samples": 4000, "edges": 3, "budget": 1200.0, "lr": 0.01,
             "batch": 32}
# (edges, interval, ...) a round or event: the decisions a card run must
# share with the CPU run (or a sweep cell with its solo run), bit for bit
SCN_DECISIONS = ("n_rounds", "interval", "active_edges", "arm_pulls",
                 "consumed", "wall", "wall_time", "budgets_left", "edge",
                 "cost", "n_active")


def kernel_spans(prof) -> list:
    """The (start, end) of every kernel a ``torch.profiler`` run saw."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.device_type == cuda)


def profile_busy(run) -> dict:
    """``run()`` once under ``torch.profiler``, the card synchronised
    around it: host ms, device ms (the union of its kernels' intervals),
    kernels, and the idle share 1 - device / host ms (the profiler's own
    overhead counts as idle)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, busy, cur = kernel_spans(prof), 0.0, None
    for a, b in spans:                       # the union of the intervals
        if cur is None or a > cur[1]:
            busy += 0.0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy = (busy + (cur[1] - cur[0] if cur else 0.0)) / 1e3
    check(spans, "the profiler saw no device time")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "idle_share": 1.0 - busy / wall_ms, "kernels": len(spans)}


def card_time(run, program, replays=None) -> dict:
    """Where a device loop's time goes, after its counted runs: one run of
    ``run`` under ``torch.profiler`` (host clock around it, the union of
    its kernels' intervals, the kernels), one chunk's graph replay timed
    by CUDA events, and the idle share by CUDA events, 1 - replays x
    replay ms / the run's host ms (every chunk replays the whole graph;
    the profiler's own overhead counts as idle in the profiled share).
    ``replays`` is a run's replays (default: the program's last run's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_busy(run)
    prof_ms, busy = prof["wall_ms"], prof["device_ms"]
    if replays is None:
        replays = program.last_run["replays"]
    with profile(activities=[ProfilerActivity.CUDA]) as one:
        program.graph.replay()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        program.graph.replay()
    end.record()
    end.synchronize()
    replay_ms = start.elapsed_time(end) / 20
    return {"wall_ms": wall_ms, "profiled_ms": prof_ms,
            "device_ms": busy, "idle_share": prof["idle_share"],
            "kernels": prof["kernels"], "replays": replays,
            "kernels_per_chunk_round": len(kernel_spans(one))
            / program.rounds_per_chunk,
            "replay_ms": replay_ms,
            "idle_share_events": 1.0 - replays * replay_ms / wall_ms}


def scenario_spec(rate=0.2):
    from repro_torch.el.scenarios import ChurnSpec, CostSpec, ScenarioSpec
    return ScenarioSpec(churn=ChurnSpec(rate=rate, period=32),
                        cost=CostSpec(kind="pareto", alpha=2.0, period=64),
                        drift=0.01)


def scenario_session(fx, init, mode, policy="ol4el"):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                              utility=fx["utility"], policy=policy,
                              scenario=scenario_spec())
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def same_raw(a: dict, b: dict) -> list:
    """The decision fields in which two runs' ``out`` dicts differ."""
    import numpy as np
    return [k for k in SCN_DECISIONS if (k in a or k in b) and not (
        k in a and k in b and np.array_equal(np.asarray(a[k]),
                                             np.asarray(b[k])))]


def scenario_solo_runs(fixtures) -> dict:
    """(a) solo runs: card vs CPU on replayed draws, the replay oracle, then
    the main path on the card's own generator, counted."""
    import math
    import torch
    from repro_torch.el.scenarios import verify_sync_replay
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops

    runs = [(mode, pol) for mode in ("sync",) for pol in SCN_POLICIES] + \
        [("async", "ol4el")]
    for arch, fx in fixtures.items():
        init = params_to_numpy(fx["cuda"]["init_params"])
        bound = flip_bound(arch, fx["cpu"]["executor"].eval_set["y"].numpy())
        for mode, pol in runs:
            reps = {}
            for dev in ("cuda", "cpu"):
                sess = scenario_session(fx[dev], params_from_numpy(init, dev),
                                        mode, pol)
                batch = fx[dev]["executor"].batch
                if mode == "sync":
                    reps[dev] = sess.run_sync_ingraph(
                        max_rounds=COMPILED_ROUNDS,
                        draws=replay_draws(sess.cfg, batch, seed=7))
                    verify_sync_replay(sess.cfg, reps[dev].raw,
                                       COMPILED_ROUNDS)
                else:
                    reps[dev] = sess.run_async_ingraph(
                        draws=async_replay_draws(sess.cfg, batch, seed=7))
            gpu, cpu = reps["cuda"], reps["cpu"]
            differ = same_raw(gpu.raw, cpu.raw)
            n = gpu.n_aggregations
            emit("scenario_vs_cpu", arch=arch, mode=mode, policy=pol,
                 draws="replayed (numpy seed 7)", rounds=n,
                 cpu_rounds=cpu.n_aggregations, differing_fields=differ,
                 active_edges_min=int(gpu.raw["active_edges"][:n].min()),
                 arm_pulls=gpu.arm_pulls, reason=gpu.terminated_reason,
                 cpu_reason=cpu.terminated_reason,
                 replay_oracle="passed" if mode == "sync" else "sync only",
                 final_metric=gpu.final_metric,
                 cpu_final_metric=cpu.final_metric, flip_bound=bound,
                 device_loop=gpu.telemetry["device_loop"])
            check(not differ and n > 0, f"scenario {arch} {mode} {pol}: "
                  f"card and CPU differ in {differ}")
            check(gpu.terminated_reason == cpu.terminated_reason,
                  f"scenario {arch} {mode} {pol}: end")
            check(abs(gpu.final_metric - cpu.final_metric) <= bound,
                  f"scenario {arch} {mode} {pol}: final metric "
                  f"{gpu.final_metric} vs CPU {cpu.final_metric}")
            check(int(gpu.raw["active_edges"][:n].min()) < 4,
                  f"scenario {arch} {mode} {pol}: no edge ever dropped")

    # (b) the card's own generator: the main path, counts read around it
    result, sessions = {}, {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, fx in fixtures.items():
        for mode, pol in runs:
            sess = scenario_session(fx["cuda"], fx["cuda"]["init_params"],
                                    mode, pol)
            sessions[arch, mode, pol] = sess
            out = []
            for _ in range(2):         # the first run captures the graph
                before = ops.batched_launches
                t0 = time.perf_counter()
                rep = (sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS)
                       if mode == "sync" else sess.run_async_ingraph())
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                loop = rep.telemetry["device_loop"]
                n = rep.n_aggregations
                out.append({"run_s": secs, "rounds": n,
                            "kernel_launches": ops.batched_launches - before,
                            "reason": rep.terminated_reason,
                            "final_metric": rep.final_metric,
                            "active_edges_mean": float(
                                rep.raw["active_edges"][:n].mean()),
                            "arm_pulls": rep.arm_pulls, **loop})
                check(n > 0 and math.isfinite(rep.final_metric)
                      and all(bool(torch.isfinite(v).all())
                              for v in rep.final_params.values()),
                      f"scenario {arch} {mode} {pol}: {rep.summary()}")
            emit("scenario", arch=arch, mode=mode, policy=pol,
                 device="cuda", draws="torch.Generator on the card, seed "
                 "cfg.seed + 17", runs=out, card=card_line())
            check(out[0]["graphs_captured"] == 1 and
                  out[1]["graphs_captured"] == 0 and
                  all(r["replays"] == r["chunks"] > 0 for r in out) and
                  out[0]["arm_pulls"] == out[1]["arm_pulls"],
                  f"scenario {arch} {mode} {pol}: graphs / replays {out}")
            if arch == "kmeans-traffic":
                for r in out:
                    # every local step of every round or event, a dropped
                    # edge's masked; the capture's warm-up chunk eagerly
                    per_graph = r["rounds_per_chunk"] * 10
                    check(r["kernel_launches_per_graph"] == per_graph and
                          r["kernel_launches"] == per_graph * (
                              r["replays"] + r["graphs_captured"]),
                          f"scenario kmeans {mode} {pol}: launches {r}")
            result[arch, mode, pol] = out
    launches = counts()
    km = [r for (arch, *_), rs in result.items() if arch == "kmeans-traffic"
          for r in rs]
    check(launches["kmeans_assign_batched"] == sum(
        r["kernel_launches"] for r in km) > 0,
        f"scenario solo: batched kmeans_assign launches {launches}")
    # the single entry runs once per kmeans run: the report's final F1
    check(launches["kmeans_assign"] == len(km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"scenario solo: unexpected kernel launches {launches}")

    # (c) where the card's time goes, past the counted runs: each scenario
    # run, and the scenario-less round and event beside it
    card = card_line()
    for arch, fx in fixtures.items():
        init = fx["cuda"]["init_params"]
        plain = {("sync", "no scenario"): compiled_session(fx["cuda"], init),
                 ("async", "no scenario"): async_session(fx["cuda"], init, 1)}
        for (mode, pol), sess in [*((k[1:], v) for k, v in sessions.items()
                                    if k[0] == arch), *plain.items()]:
            run = (lambda s=sess: s.run_sync_ingraph(
                max_rounds=COMPILED_ROUNDS)) if mode == "sync" else \
                sess.run_async_ingraph
            run()                          # the plain runs capture here
            emit("scenario_card_time", arch=arch, mode=mode, policy=pol,
                 **card_time(run, sess._fastpath), card=card)
    return launches


def churn_sessions(fixtures) -> dict:
    """The churn grid's base sessions: svm-wafer built as the churn
    benchmark builds it (its data, lr and batch), kmeans-traffic from the
    phases' fixture."""
    from repro_torch.config import get_config
    from repro_torch.data import make_wafer_dataset, partition_edges
    from repro_torch.el import ELSession
    from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec
    from repro_torch.federated import ClassicExecutor
    from repro_torch.models import build_model
    scn = ScenarioSpec(churn=ChurnSpec(rate=CHURN_RATES[0],
                                       period=CHURN_GRID["period"]))
    c = CHURN_SVM
    train, test = make_wafer_dataset(n=c["samples"], seed=0)
    exp = get_config("svm-wafer")
    model = build_model(exp.model, device="cuda")
    edges = partition_edges(train, c["edges"], alpha=100.0, seed=0)
    ex = ClassicExecutor(model, edges, test, batch=c["batch"], lr=c["lr"],
                         device="cuda")
    svm_cfg = dataclasses.replace(
        exp.ol4el, mode="sync", policy="ol4el", n_edges=c["edges"],
        budget=c["budget"], heterogeneity=CHURN_GRID["heterogeneity"],
        utility="eval_gain", seed=0, cost_noise=0.0, cost_model="fixed",
        max_interval=10, scenario=scn)
    svm = (ELSession(svm_cfg, metric_name="accuracy", lr=c["lr"],
                     async_alpha=0.5)
           .with_executor(ex, init_params=model.init(None),
                          n_samples=[len(e["y"]) for e in edges]))
    fx = fixtures["kmeans-traffic"]["cuda"]
    km_cfg = dataclasses.replace(
        fx["exp"].ol4el, mode="sync", policy="ol4el", n_edges=4,
        utility=fx["utility"], heterogeneity=CHURN_GRID["heterogeneity"],
        scenario=scn)
    km = (ELSession(km_cfg, metric_name=fx["metric"], lr=fx["lr"])
          .with_executor(fx["executor"], init_params=fx["init_params"],
                         n_samples=fx["n_samples"]))
    return {"svm-wafer": svm, "kmeans-traffic": km}


def churn_grid(fixtures) -> dict:
    """(c) the churn grid through ``ELSession.sweep``, twice (the first
    capturing), counted; every cell against a solo run of its config.
    Phase 4g runs the svm grid again through the churn benchmark and
    holds its seed-means against the reference package's record."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.el.scenarios import INGRAPH_POLICY_ORDER
    from repro_torch.el.sweep import SweepSpec
    from repro_torch.kernels.kmeans_assign import ops

    spec = SweepSpec(policy=INGRAPH_POLICY_ORDER, churn_rate=CHURN_RATES,
                     seeds=CHURN_SEEDS, max_rounds=CHURN_GRID["max_rounds"])
    sessions = churn_sessions(fixtures)
    warnings.filterwarnings("error", message=PERF_DROP)
    reports, runs = {}, {}
    reset_counts()
    torch.cuda.synchronize()
    for arch, sess in sessions.items():
        runs[arch] = []
        for _ in range(2):
            before = ops.batched_launches
            t0 = time.perf_counter()
            rep = sess.sweep(spec)
            torch.cuda.synchronize()
            loops = rep.telemetry["device_loops"]
            runs[arch].append({
                "run_s": time.perf_counter() - t0, "cells": rep.n_cells,
                "chunks": sum(lp["chunks"] for lp in loops),
                "replays": sum(lp["replays"] for lp in loops),
                "graphs_captured": sum(lp["graphs_captured"]
                                       for lp in loops),
                "kernel_launches": ops.batched_launches - before,
                "kernel_launches_per_graph": loops[0][
                    "kernel_launches_per_graph"],
                "rounds": [int(n) for n in rep.out["n_rounds"]]})
        reports[arch] = rep
    launches = counts()
    warnings.filterwarnings("default", message=PERF_DROP)
    km = runs["kmeans-traffic"]
    for r in km:
        check(r["kernel_launches_per_graph"] == 160 and
              r["kernel_launches"] == 160 * (r["replays"] +
                                             r["graphs_captured"]),
              f"churn grid kmeans: launches {r}")
    check(launches["kmeans_assign_batched"] == sum(
        r["kernel_launches"] for r in km) > 0,
        f"churn grid: batched kmeans_assign launches {launches}")
    # the single entry scores each kmeans cell's final params (F1)
    check(launches["kmeans_assign"] == sum(r["cells"] for r in km) and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"churn grid: unexpected kernel launches {launches}")

    for arch, sess in sessions.items():
        # where the card's time goes, past the counted runs
        emit("churn_grid_card_time", arch=arch, **card_time(
            lambda s=sess: s.sweep(spec), sess._sweep_programs[0]),
            card=card_line())

    for arch, rep in reports.items():
        sess = sessions[arch]
        check(rep.n_cells == 27 and not rep.truncated().any(),
              f"churn grid {arch}: truncated cells {rep.truncated()}")
        check(runs[arch][0]["graphs_captured"] == 1 and
              runs[arch][1]["graphs_captured"] == 0,
              f"churn grid {arch}: graphs {runs[arch]}")
        solo_s, metric_diff = 0.0, 0.0
        for i, ccfg in enumerate(spec.cell_cfgs(sess.cfg)):
            sess_cfg, sess.cfg = sess.cfg, ccfg
            if i == 0:                 # capture the solo graph
                sess.run_sync_ingraph(max_rounds=spec.max_rounds)
            t0 = time.perf_counter()
            solo = sess.run_sync_ingraph(max_rounds=spec.max_rounds)
            torch.cuda.synchronize()
            solo_s += time.perf_counter() - t0
            sess.cfg = sess_cfg
            cell = {k: v[i] for k, v in rep.out.items()}
            differ = same_raw(cell, solo.raw)
            check(not differ, f"churn grid {arch} cell {i} "
                  f"({rep.cells[i]}): differs from its solo run in {differ}")
            metric_diff = max(metric_diff, max_diff(cell["metric"],
                                                    solo.raw["metric"]))
        rows = rep.grouped_rows()
        table = []
        for g in rows:
            row = {"policy": g["policy"], "churn_rate": g["churn_rate"],
                   "n_seeds": g["n_seeds"], "metric": g["final_metric"],
                   "metric_std": g["final_metric_std"],
                   "consumed": g["total_consumed"]}
            if arch == "svm-wafer":
                check(np.isfinite(g["final_metric"]) and
                      0.5 < g["final_metric"],
                      f"churn grid svm {g['policy']} rate "
                      f"{g['churn_rate']}: accuracy {g['final_metric']}")
            table.append(row)
        emit("churn_grid", arch=arch, device="cuda", spec=spec.describe(
            sess.cfg), draws="torch.Generator per cell on the card, seed + "
             "17", runs=runs[arch], solo_runs_s=solo_s,
             same_decisions_as_solo=True, max_metric_diff=metric_diff,
             rows=table, card=card_line())
    return launches


def scenario_phase(fixtures) -> dict:
    solo = scenario_solo_runs(fixtures)
    grid = churn_grid(fixtures)
    return {"kmeans_assign": solo["kmeans_assign"] + grid["kmeans_assign"],
            "kmeans_assign_batched": solo["kmeans_assign_batched"],
            "kmeans_assign_batched_cells": grid["kmeans_assign_batched"]}


# -- phase 4f: the fleet server -----------------------------------------------

# three cohorts at the phases' full width (kmeans-traffic sync and async
# K = 1, svm-wafer sync), 8 tenants each through 4 slots, a wave the
# 16-step chunk of phases 4b-4e; tenant i has seed i, one of them
# priority 2.  Sync budgets run from 2500 to 5000 per edge; the async
# cohort's from 4000 to 5000, which all pad to one event horizon (512),
# as the reference demo's async tenants share one program (2500 pads to
# 256: a second program)
FLEET_SLOTS, FLEET_WAVE, FLEET_TENANTS, FLEET_PRIORITY = 4, 16, 8, 5
FLEET_UCB = (0.5, 1.0, 2.0, 1.5, 0.75, 1.25, 2.0, 0.5)
FLEET_COHORTS = (("kmeans-traffic", "sync", 2500.0),
                 ("kmeans-traffic", "async", 4000.0),
                 ("svm-wafer", "sync", 2500.0))
FLEET_PAIRS = FLEET_SLOTS * 4      # (slot, edge) pairs a kmeans launch


class WaveClock:
    """Host seconds a cohort spends in each part of its waves: admission
    (``Cohort._admit``: init_slot, the place_many scatter), the step
    (``CellBatch.step``: draw refill, the graph replay, the status read)
    and the harvest (``Cohort._harvest``: the new history rows, the
    deltas, the take_many gather and finalize); and the wave each
    admission landed in."""

    PARTS = ("_admit", "step", "_harvest")

    def __init__(self):
        from repro_torch.el.fleet.cohort import Cohort
        from repro_torch.el.sweep.engine import CellBatch
        self.seconds, self.admits, self.saved = {}, {}, []
        for cls, name in zip((Cohort, CellBatch, Cohort), self.PARTS):
            self._wrap(cls, name)

    def _wrap(self, cls, name):
        orig, clock = getattr(cls, name), self
        self.saved.append((cls, name, orig))

        def timed(obj, *a, **kw):
            t0 = time.perf_counter()
            out = orig(obj, *a, **kw)
            key = (id(obj), name)
            clock.seconds[key] = clock.seconds.get(key, 0.0) + \
                time.perf_counter() - t0
            if name == "_admit" and out:
                clock.admits.setdefault(id(obj), []).append(
                    (obj.waves, out))
            return out
        setattr(cls, name, timed)

    def cohort_ms(self, cohort) -> dict:
        """A cohort's host ms in each part over its waves."""
        return {part: 1e3 * self.seconds.get((id(obj), part), 0.0)
                for obj, part in zip((cohort, cohort.batch, cohort),
                                     self.PARTS)}

    def mid_flight(self, cohort) -> int:
        """Tenants admitted after the cohort's first wave."""
        return sum(n for wave, n in self.admits.get(id(cohort), [])
                   if wave > 0)

    def reset(self):
        self.seconds, self.admits = {}, {}

    def close(self):
        for cls, name, orig in self.saved:
            setattr(cls, name, orig)


def fleet_runs(fixtures) -> dict:
    """Each cohort's 8 tenant configs, by (arch, mode)."""
    out = {}
    for arch, mode, lo in FLEET_COHORTS:
        fx = fixtures[arch]["cuda"]
        base = dataclasses.replace(fx["exp"].ol4el, mode=mode, n_edges=4,
                                   utility=fx["utility"])
        out[arch, mode] = [dataclasses.replace(
            base, budget=lo + (5000.0 - lo) * i / (FLEET_TENANTS - 1),
            ucb_c=FLEET_UCB[i], seed=i) for i in range(FLEET_TENANTS)]
    return out


def fleet_server(fixtures, cfgs, cache, mesh=None):
    """A server on the card over ``cache`` (and ``mesh``) with every
    tenant submitted in order (tenant ids ``arch/mode/i``); the
    subscriber's events by tenant."""
    from repro_torch.el.fleet import FleetServer, TenantRun
    server = FleetServer(n_slots=FLEET_SLOTS, rounds_per_wave=FLEET_WAVE,
                         cache=cache, mesh=mesh)
    events = {}
    server.subscribe(lambda ev: events.setdefault(ev.tenant_id,
                                                  []).append(ev))
    for (arch, mode), tenants in cfgs.items():
        fx = fixtures[arch]["cuda"]
        for i, cfg in enumerate(tenants):
            server.submit(TenantRun(
                cfg=cfg, executor=fx["executor"],
                tenant_id=f"{arch}/{mode}/{i}",
                priority=2 if i == FLEET_PRIORITY else 0,
                metric_name=fx["metric"], n_samples=fx["n_samples"],
                init_params=fx["init_params"]))
    return server, events


def _records(rep):
    import numpy as np
    return np.array([dataclasses.astuple(r) for r in rep.records])


def fleet_digest(rep) -> dict:
    """A tenant's report, field for field and bit for bit (what
    ``same_fleet_report`` compares)."""
    return {"records": out_digest(_records(rep)), "params": tree_digest(
        rep.final_params), "summary": [rep.arm_pulls, rep.n_aggregations,
                                       rep.total_consumed, rep.wall_time,
                                       rep.terminated_reason,
                                       repr(rep.final_metric)]}


def same_fleet_report(got, want) -> bool:
    """Field for field and bit for bit: records (NaN metrics equal),
    arm pulls, rounds, consumption, time, end, final metric and final
    parameters."""
    import math
    import numpy as np
    import torch
    return (np.array_equal(_records(got), _records(want), equal_nan=True)
            and (got.arm_pulls, got.n_aggregations, got.total_consumed,
                 got.wall_time, got.terminated_reason)
            == (want.arm_pulls, want.n_aggregations, want.total_consumed,
                want.wall_time, want.terminated_reason)
            and (got.final_metric == want.final_metric or (
                math.isnan(got.final_metric)
                and math.isnan(want.final_metric)))
            and all(torch.equal(got.final_params[k], v)
                    for k, v in want.final_params.items()))


def fleet_drain(fixtures, cfgs, cache, clock, spans_path=None) -> dict:
    """Drain every tenant through a fresh server over ``cache`` (with a
    JSONL tracer when ``spans_path`` is given); per cohort its waves,
    admissions, dispatches, replays and host ms by part."""
    import torch
    from repro_torch.obs import trace
    clock.reset()
    if spans_path is not None:           # from the cache lookups on
        spans_path.parent.mkdir(parents=True, exist_ok=True)
        spans_path.unlink(missing_ok=True)
        prev = trace.get_tracer()
        trace.configure(jsonl_path=str(spans_path))
    server, events = fleet_server(fixtures, cfgs, cache)
    replays0 = {c.key: c.batch.program.replays for c in server.cohorts()}
    t0 = time.perf_counter()
    reports = server.drain()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if spans_path is not None:
        trace.use_tracer(prev).close()
    cohorts = {}
    for c in server.cohorts():
        p, ms = c.batch.program, clock.cohort_ms(c)
        cohorts[c.key] = {
            "waves": c.waves, "admitted": c.admitted,
            "admitted_mid_flight": clock.mid_flight(c),
            "place_dispatches": c.place_dispatches,
            "gather_dispatches": c.gather_dispatches,
            "replays": p.replays - replays0[c.key],
            "graphs_captured": p.graphs_captured,
            "launches_per_graph": p.launches_per_graph,
            "waves_s": sum(ms.values()) / 1e3,
            "host_ms_per_wave": {k.strip("_"): v / c.waves
                                 for k, v in ms.items()}}
    out = {"drain_s": secs, "reports": reports, "events": events,
           "stats": server.stats(), "cohorts": cohorts}
    server.close()
    return out


def fleet_phase(fixtures) -> dict:
    import numpy as np
    import torch
    from repro_torch.el import ELSession
    from repro_torch.el.cache import ProgramCache
    from repro_torch.el.events import padded_event_horizon
    from repro_torch.el.fleet import ReportReady, RoundDelta
    from repro_torch.obs import trace

    card = card_line()
    cfgs = fleet_runs(fixtures)
    check(len({padded_event_horizon(c)
               for c in cfgs["kmeans-traffic", "async"]}) == 1,
          "fleet: the async budgets pad to more than one event horizon")
    n_tenants = sum(len(t) for t in cfgs.values())
    km_ex = fixtures["kmeans-traffic"]["cuda"]["executor"]
    cache = ProgramCache(8)
    clock = WaveClock()
    spans_path = ROOT / "build" / "fleet_spans.jsonl"

    # (a) the main path, counts read around it: a drain that captures each
    # cohort's graph, then a traced drain on a fresh server sharing the
    # cache, which reuses them
    reset_counts()
    torch.cuda.synchronize()
    drains = [fleet_drain(fixtures, cfgs, cache, clock),
              fleet_drain(fixtures, cfgs, cache, clock, spans_path)]
    launches = counts()
    clock.close()

    first, second = drains
    check(first["stats"]["compiles"] == 3 and first["stats"]["cohorts"] == 3
          and second["stats"]["compiles"] == 0,
          f"fleet: compiles / cohorts {first['stats']} {second['stats']}")
    by_name = {}
    for e in trace.read_jsonl(str(spans_path)):
        by_name.setdefault(e["name"], []).append(e)
    check(len(by_name.get("cohort.wave", [])) == second["stats"]["waves"]
          and len(by_name.get("cohort.refill", [])) == n_tenants
          and "fleet.compile" not in by_name
          and len(by_name.get("cache.hit", [])) == 3,
          "fleet: the traced drain's records "
          f"{ {k: len(v) for k, v in by_name.items()} }")
    for d in drains:
        st = d["stats"]
        check(len(d["reports"]) == n_tenants == st["tenants_done"],
              f"fleet: {len(d['reports'])} reports")
        check(1 <= st["place_dispatches"] <= st["waves"]
              and 1 <= st["gather_dispatches"] <= st["waves"],
              f"fleet: dispatches over waves {st}")
        for c in d["cohorts"].values():
            check(c["graphs_captured"] == 1
                  and c["replays"] == c["waves"] > 0
                  and c["admitted"] == FLEET_TENANTS
                  and c["admitted_mid_flight"] >= FLEET_TENANTS - FLEET_SLOTS
                  and 1 <= c["place_dispatches"] <= c["waves"]
                  and 1 <= c["gather_dispatches"] <= c["waves"],
                  f"fleet: a cohort's graphs / waves / dispatches {c}")
        for tid, evs in d["events"].items():
            check(isinstance(evs[-1], ReportReady)
                  and all(isinstance(e, RoundDelta) for e in evs[:-1])
                  and np.array_equal(
                      np.array([dataclasses.astuple(e.record)
                                for e in evs[:-1]]),
                      _records(d["reports"][tid]), equal_nan=True),
                  f"fleet {tid}: the streamed deltas are not its records")
    for tid, rep in first["reports"].items():
        check(same_fleet_report(second["reports"][tid], rep),
              f"fleet {tid}: the traced drain's report differs")
    # the priority tenant is admitted before the FIFO tenants queued with
    # it: it takes a first-wave slot, the last first-wave FIFO one waits
    order = [e["tenant"] for e in by_name["cohort.refill"]]
    for arch, mode in cfgs:
        mine = [t.rsplit("/", 1)[1] for t in order
                if t.startswith(f"{arch}/{mode}/")]
        check(mine[0] == str(FLEET_PRIORITY) and
              mine.index(str(FLEET_SLOTS - 1)) >= FLEET_SLOTS,
              f"fleet {arch} {mode}: admission order {mine}")

    def km_launches(d, captured):
        return sum(c["launches_per_graph"] * (c["replays"] + captured)
                   for k, c in d["cohorts"].items() if k[1] is km_ex)
    check(launches["kmeans_assign_batched"] ==
          km_launches(first, 1) + km_launches(second, 0) > 0,
          f"fleet: batched kmeans_assign launches {launches}")
    # the single entry scores each kmeans tenant's final params (F1)
    check(launches["kmeans_assign"] == 2 * 2 * FLEET_TENANTS
          and launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"fleet: unexpected kernel launches {launches}")

    # (b) every tenant against its solo run on the card's default draws;
    # the solo runs share one program per cohort, captured before the sum
    solo_s = {}
    for (arch, mode), tenants in cfgs.items():
        fx = fixtures[arch]["cuda"]
        sess = (ELSession(tenants[0], metric_name=fx["metric"], lr=fx["lr"])
                .with_executor(fx["executor"], init_params=fx["init_params"],
                               n_samples=fx["n_samples"]
                               if mode == "sync" else None))
        run = (sess.run_sync_ingraph if mode == "sync"
               else sess.run_async_ingraph)
        run()                                # capture the solo graph
        solo_s[arch, mode] = 0.0
        for i, cfg in enumerate(tenants):
            sess.cfg = cfg
            t0 = time.perf_counter()
            ind = run()
            torch.cuda.synchronize()
            solo_s[arch, mode] += time.perf_counter() - t0
            got = first["reports"][f"{arch}/{mode}/{i}"]
            check(ind.terminated_reason == "budget_exhausted"
                  and same_fleet_report(got, ind),
                  f"fleet {arch} {mode} tenant {i}: {got.summary()} vs the "
                  f"solo run's {ind.summary()}")

    for key in first["cohorts"]:
        arch = "kmeans-traffic" if key[1] is km_ex else "svm-wafer"
        mode = key[2].mode
        rows = [d["cohorts"][key] for d in drains]
        reports = [first["reports"][f"{arch}/{mode}/{i}"]
                   for i in range(FLEET_TENANTS)]
        emit("fleet", arch=arch, mode=mode, device="cuda",
             draws="torch.Generator per tenant on the card, seed + 17",
             slots=FLEET_SLOTS, rounds_per_wave=FLEET_WAVE,
             tenants=FLEET_TENANTS,
             budgets=[c.budget for c in cfgs[arch, mode]],
             cohort_waves_s=[r["waves_s"] for r in rows],
             solo_runs_s=solo_s[arch, mode], same_reports_as_solo=True,
             waves=[r["waves"] for r in rows],
             admitted_mid_flight=[r["admitted_mid_flight"] for r in rows],
             host_ms_per_wave=[r["host_ms_per_wave"] for r in rows],
             place_dispatches=[r["place_dispatches"] for r in rows],
             gather_dispatches=[r["gather_dispatches"] for r in rows],
             batched_launches=[r["launches_per_graph"]
                               * (r["replays"] + (i == 0))
                               for i, r in enumerate(rows)]
             if arch == "kmeans-traffic" else 0,
             launches_per_graph=rows[0]["launches_per_graph"],
             pairs_a_launch=FLEET_PAIRS if arch == "kmeans-traffic"
             else None,
             rounds=[r.n_aggregations for r in reports],
             final_metrics=[r.final_metric for r in reports], card=card)
    emit("fleet_drains", drain_s=[d["drain_s"] for d in drains],
         note="three cohorts' waves interleaved in one server; the first "
              "drain captures each cohort's graph, the second (traced, a "
              "fresh server on the same cache) reuses them",
         stats=[d["stats"] for d in drains],
         trace_records={k: len(v) for k, v in by_name.items()},
         solo_runs_s=sum(solo_s.values()), card=card)

    # (c) where the card's time goes, past the counted runs: the kmeans
    # sync cohort's drain alone, its graph reused
    km_sync = {("kmeans-traffic", "sync"): cfgs["kmeans-traffic", "sync"]}
    probe = {}

    def run():
        server, _ = fleet_server(fixtures, km_sync, cache)
        server.drain()
        torch.cuda.synchronize()
        probe["waves"] = server.stats()["waves"]
        probe["program"] = server.cohorts()[0].batch.program
        server.close()
    run()
    ct = card_time(run, probe["program"], replays=probe["waves"])
    emit("fleet_card_time", arch="kmeans-traffic", mode="sync",
         waves=probe["waves"],
         kernels_a_wave=ct["kernels_per_chunk_round"] * FLEET_WAVE, **ct,
         card=card)
    return {"kmeans_assign": launches["kmeans_assign"],
            "kmeans_assign_batched_cells": launches["kmeans_assign_batched"],
            "kmeans_async": {
                tid: fleet_digest(rep) for tid, rep in
                first["reports"].items()
                if tid.startswith("kmeans-traffic/async/")},
            "kmeans_async_waves_s": [
                c["waves_s"] for k, c in second["cohorts"].items()
                if k[1] is km_ex and k[2].mode == "async"][0]}


# -- phase 4h: the device telemetry rings and program profiles ----------------

# the default ring (128), and a ring of 16 that every sync run wraps; the
# async runs (234 / 224 events) wrap the default one
TELEM_RING, TELEM_SHORT = 128, 16
# (mode, wave width, scenario): the compiled paths a ring records in
TELEM_CASES = (("sync", 1, False), ("async", 1, False),
               ("async", ASYNC_WAVE, False), ("sync", 1, True),
               ("async", 1, True))
TELEM_TIMED = 3                   # timed runs a side, on and off alternating
TELEM_COHORT = ("kmeans-traffic", "sync")        # one of phase 4f's cohorts


def telemetry_session(fx, mode, batch_k=1, scenario=False):
    from repro_torch.el import ELSession
    cfg = dataclasses.replace(
        fx["exp"].ol4el, mode=mode, n_edges=4, utility=fx["utility"],
        async_batch_k=batch_k if mode == "async" else 0,
        scenario=scenario_spec() if scenario else None)
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))


def same_out(a: dict, b: dict) -> bool:
    """Two runs' ``out`` dicts, the rings left aside, bit for bit."""
    import numpy as np
    keys = set(a) - {"telemetry"}
    return keys == set(b) - {"telemetry"} and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k]), equal_nan=True)
        for k in keys)


def ring_mismatch(got: dict, want: dict, util_tol: float = 0.0) -> list:
    """The fields in which two runs' unrolled rings differ: every field
    bit for bit, ``arm_utility`` (sums of utilities) to ``util_tol``."""
    import numpy as np
    from repro_torch.obs.rings import unroll_ring
    g, w = unroll_ring(got), unroll_ring(want)
    if g.keys() != w.keys():
        return ["keys"]
    bad = []
    for k in w:
        if g[k].shape != w[k].shape:
            bad.append(k)
        elif k == "arm_utility" and util_tol:
            if not np.allclose(g[k], w[k], rtol=0.0, atol=util_tol):
                bad.append(k)
        elif not np.array_equal(g[k], w[k]):
            bad.append(k)
    return bad


def oracle_mismatch(rep, cfg) -> list:
    """The fields in which a fixed-cost run's unrolled rings differ from
    the port's numpy replay of its history."""
    import numpy as np
    from repro_torch.el.events import async_knobs
    from repro_torch.el.ingraph import sync_knobs
    from repro_torch.obs import rings
    if cfg.mode == "sync":
        want = rings.sync_reference_telemetry(rep.raw, sync_knobs(cfg),
                                              cfg.max_interval)
    else:
        want = rings.async_reference_telemetry(
            rep.raw, async_knobs(cfg), cfg.n_edges, cfg.max_interval)
    got = rings.unroll_ring(rep.telemetry["rings"])
    return [k for k in want if not np.array_equal(got[k], want[k])]


def telemetry_runs(fixtures) -> dict:
    """(a) every compiled path with the rings off and on: the same run,
    rings that wrap, equal to the replay oracle; the sessions, by
    (arch, mode, wave width, scenario)."""
    import numpy as np
    from repro_torch.kernels.kmeans_assign import ops
    card = card_line()
    sessions = {}
    for arch, fx in fixtures.items():
        for mode, bk, scn in TELEM_CASES:
            sess = telemetry_session(fx["cuda"], mode, bk, scn)
            run = (sess.run_sync_ingraph if mode == "sync"
                   else sess.run_async_ingraph)
            off = run()
            rows = []
            for ring in ((TELEM_RING, TELEM_SHORT) if mode == "sync"
                         and not scn else (TELEM_RING,)):
                before = ops.batched_launches
                on = run(telemetry=ring)
                launched = ops.batched_launches - before
                loop, rings = on.telemetry["device_loop"], \
                    on.telemetry["rings"]
                n = on.n_aggregations
                same = same_fleet_report(on, off) and same_out(on.raw,
                                                                off.raw)
                check(same, f"rings {arch} {mode} K={bk} scenario={scn} "
                      f"ring {ring}: the run differs from the unringed one")
                check(int(rings["head"]) == n and
                      int(rings["ring_size"]) == ring and
                      on.terminated_reason == "budget_exhausted",
                      f"rings {arch} {mode}: head {rings['head']} of {n}")
                oracle = [] if scn else oracle_mismatch(on, sess.cfg)
                check(not oracle, f"rings {arch} {mode} K={bk} ring {ring}:"
                      f" the replay oracle differs in {oracle}")
                if scn:
                    act = rings["active_edges"][:min(n, ring)]
                    check(((act >= 0) & (act <= 4)).all() and
                          int(np.asarray(rings["dropouts"]).sum()) > 0,
                          f"rings {arch} {mode} scenario: activity {act}")
                if arch == "kmeans-traffic":
                    check(launched == loop["kernel_launches_per_graph"] * (
                        loop["replays"] + loop["graphs_captured"]) > 0,
                        f"rings {arch} {mode}: batched launches {launched}"
                        f" for {loop}")
                rows.append({"ring": ring, "rounds": n, "wraps": n > ring,
                             "same_run_as_unringed": same,
                             "oracle": "not defined (scenario)" if scn
                             else "equal",
                             "batched_launches": launched,
                             "chunks": loop["chunks"],
                             "graphs_captured": loop["graphs_captured"]})
            check(mode == "sync" or scn or rows[0]["wraps"],
                  f"rings {arch} {mode}: {rows[0]['rounds']} events do not "
                  f"wrap the default ring")
            emit("rings", arch=arch, mode=mode, batch_k=bk, scenario=scn,
                 device="cuda", draws="torch.Generator on the card, seed "
                 "cfg.seed + 17", runs=rows, card=card)
            sessions[arch, mode, bk, scn] = sess
    return sessions


def telemetry_profiles(fixtures, sessions) -> dict:
    """(b) ``profile=True, contract=True`` on the sync round and the async
    engine, rings off and on: no collectives, nothing aliased, the
    memory fields measured; an impossible contract raises before any
    replay."""
    from repro_torch.obs import prof
    card = card_line()
    peaks = {}
    for arch, fx in fixtures.items():
        for mode in ("sync", "async"):
            sess = sessions[arch, mode, 1, False]
            run = (sess.run_sync_ingraph if mode == "sync"
                   else sess.run_async_ingraph)
            for ring in (None, TELEM_RING):
                rep = run(telemetry=ring, profile=True, contract=True)
                p = rep.telemetry["profile"]
                check(p["collectives"] == {} and p["alias_bytes"] == 0
                      and p["collective_bytes"] == 0 and not p["donated"]
                      and p["errors"] == [] and p["backend"] == "cuda"
                      and all(p[f] is not None and p[f] > 0 for f in (
                          "argument_bytes", "output_bytes", "temp_bytes",
                          "peak_live_bytes"))
                      and p["peak_live_bytes"] == p["argument_bytes"]
                      + p["output_bytes"] + p["temp_bytes"],
                      f"profile {arch} {mode} ring {ring}: {p}")
                peaks[arch, mode, ring] = p
                emit("profile", arch=arch, mode=mode, rings=ring,
                     device="cuda", **{k: p[k] for k in (
                         "argument_bytes", "output_bytes", "temp_bytes",
                         "alias_bytes", "peak_live_bytes", "flops",
                         "collectives", "donated")}, card=card)
        fresh = telemetry_session(fx["cuda"], "sync")
        impossible = prof.CollectiveContract(
            "impossible", counts={"all-gather": (5, 99)})
        try:
            fresh.run_sync_ingraph(contract=impossible)
            raised = False
        except prof.ContractViolation:
            raised = True
        check(raised and fresh._fastpath.replays == 0,
              f"profile {arch}: an impossible contract did not raise "
              "before dispatch")
    return peaks


def telemetry_sweep(fixtures) -> dict:
    """(c) phase 4d's 24-cell sync grid with the rings on: the grid the
    unringed grid, every cell's rings its solo card run's; the largest
    ``arm_utility`` difference, which the vmapped cells' reductions may
    round apart."""
    import numpy as np
    import torch
    from repro_torch.el.sweep import SweepSpec
    card = card_line()
    spec = SweepSpec(**SWEEP_SYNC)
    out = {}
    for arch, fx in fixtures.items():
        sess = sweep_session(fx["cuda"], "sync")
        off = sess.sweep(spec)
        on = sess.sweep(spec, telemetry=True)
        same = (same_out(on.out, off.out) and all(
            torch.equal(on.final_params[k], v)
            for k, v in off.final_params.items()))
        check(same, f"rings sweep {arch}: the grid differs from the "
              "unringed grid")
        solo = sweep_session(fx["cuda"], "sync")
        util, heads = 0.0, []
        for i, ccfg in enumerate(spec.cell_cfgs(sess.cfg)):
            solo.cfg = ccfg
            ind = solo.run_sync_ingraph(max_rounds=spec.max_rounds,
                                        telemetry=True)
            cell = {k: np.asarray(v)[i]
                    for k, v in on.out["telemetry"].items()}
            bad = ring_mismatch(cell, ind.telemetry["rings"], util_tol=1e-4)
            check(not bad, f"rings sweep {arch} cell {i}: {bad} differ "
                  "from the solo run's")
            util = max(util, float(np.abs(
                cell["arm_utility"] - ind.telemetry["rings"]["arm_utility"]
            ).max()))
            heads.append(int(cell["head"]))
        emit("rings_sweep", arch=arch, device="cuda", cells=spec.n_cells,
             ring=TELEM_RING, heads=heads, same_grid_as_unringed=same,
             rings_equal_solo_runs=True, max_arm_utility_diff=util,
             card=card)
        out[arch] = util
    return out


def telemetry_cohort(fixtures) -> dict:
    """(d) phase 4f's kmeans sync cohort (8 tenants through 4 slots, waves
    of 16) on a server with the rings and the profile on: every tenant's
    report bit for bit its solo card run's, rings included, the cohort's
    (donated) profile on every report."""
    import numpy as np
    from repro_torch.el import ELSession
    from repro_torch.el.cache import ProgramCache
    from repro_torch.el.fleet import FleetServer, TenantRun
    card = card_line()
    arch, mode = TELEM_COHORT
    cfgs = fleet_runs(fixtures)[arch, mode]
    fx = fixtures[arch]["cuda"]
    server = FleetServer(n_slots=FLEET_SLOTS, rounds_per_wave=FLEET_WAVE,
                         cache=ProgramCache(2), telemetry=True, profile=True)
    for i, cfg in enumerate(cfgs):
        server.submit(TenantRun(cfg=cfg, executor=fx["executor"],
                                tenant_id=f"{i}", metric_name=fx["metric"],
                                n_samples=fx["n_samples"],
                                init_params=fx["init_params"]))
    reports = server.drain()
    stats = server.stats()
    server.close()
    solo = (ELSession(cfgs[0], metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=fx["init_params"],
                           n_samples=fx["n_samples"]))
    profiles = []
    for i, cfg in enumerate(cfgs):
        solo.cfg = cfg
        ind = solo.run_sync_ingraph(telemetry=True)
        got = reports[f"{i}"]
        bad = ring_mismatch(got.telemetry["rings"], ind.telemetry["rings"])
        check(same_fleet_report(got, ind) and not bad,
              f"rings cohort tenant {i}: {bad} / {got.summary()} vs the solo"
              f" run's {ind.summary()}")
        profiles.append(got.telemetry["profile"])
    p = profiles[0]
    check(all(q == p for q in profiles) and p["donated"] and
          p["errors"] == [] and 0 < p["alias_bytes"] < p["argument_bytes"]
          and p["collectives"] == {} and p["temp_bytes"] is not None
          and p["peak_live_bytes"] == p["argument_bytes"]
          + p["output_bytes"] + p["temp_bytes"] - p["alias_bytes"],
          f"rings cohort: the profile {p}")
    emit("rings_cohort", arch=arch, mode=mode, device="cuda",
         tenants=len(cfgs), slots=FLEET_SLOTS, waves=stats["waves"],
         rounds=[reports[f"{i}"].n_aggregations for i in range(len(cfgs))],
         rings_equal_solo_runs=True, **{k: p[k] for k in (
             "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
             "peak_live_bytes", "donated")}, card=card)
    return p


def telemetry_timing(sessions) -> dict:
    """(e) past the counted runs: each path's seconds with the rings off
    and on, both on reused graphs (alternating, the median of
    ``TELEM_TIMED`` a side), and through ``card_time`` the kernels a
    chunk round and the replay ms each side."""
    import statistics
    import torch
    card = card_line()
    out = {}
    for (arch, mode, bk, scn), sess in sessions.items():
        run = (sess.run_sync_ingraph if mode == "sync"
               else sess.run_async_ingraph)
        secs = {None: [], TELEM_RING: []}
        for _ in range(TELEM_TIMED):
            for ring in secs:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(telemetry=ring)
                torch.cuda.synchronize()
                secs[ring].append(time.perf_counter() - t0)
        off_s = statistics.median(secs[None])
        on_s = statistics.median(secs[TELEM_RING])
        row = {"off_s": off_s, "on_s": on_s, "ratio": on_s / off_s,
               "off_runs_s": secs[None], "on_runs_s": secs[TELEM_RING]}
        if arch == "kmeans-traffic" and not scn and bk == 1:
            for ring, name in ((None, "off"), (TELEM_RING, "on")):
                run(telemetry=ring)
                ct = card_time(lambda r=ring: run(telemetry=r),
                               sess._fastpath)
                row[f"{name}_kernels_per_chunk_round"] = \
                    ct["kernels_per_chunk_round"]
                row[f"{name}_replay_ms"] = ct["replay_ms"]
                row[f"{name}_idle_share_events"] = ct["idle_share_events"]
            row["kernels_added_per_chunk_round"] = (
                row["on_kernels_per_chunk_round"]
                - row["off_kernels_per_chunk_round"])
        emit("rings_timing", arch=arch, mode=mode, batch_k=bk,
             scenario=scn, device="cuda", ring=TELEM_RING, **row,
             card=card)
        out[arch, mode, bk, scn] = row
    return out


def telemetry_phase(fixtures) -> dict:
    """Phase 4h: (a)-(d) with every count set to 0 just before and read
    just after, then (e)."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops
    reset_counts()
    torch.cuda.synchronize()
    sessions = telemetry_runs(fixtures)
    peaks = telemetry_profiles(fixtures, sessions)
    solo = counts()["kmeans_assign_batched"]
    sweep = telemetry_sweep(fixtures)
    after_sweep = ops.batched_launches
    cohort = telemetry_cohort(fixtures)
    launches = counts()
    cells = launches["kmeans_assign_batched"] - solo
    check(solo > 0 and after_sweep > solo and
          launches["kmeans_assign_batched"] > after_sweep,
          "rings: batched kmeans_assign launches (solo runs, sweep, "
          f"cohort) {solo}, {after_sweep - solo}, "
          f"{launches['kmeans_assign_batched'] - after_sweep}")
    check(launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"rings: unexpected kernel launches {launches}")
    timing = telemetry_timing(sessions)
    emit("rings_phase", batched_launches_solo=solo,
         batched_launches_sweep=after_sweep - solo,
         batched_launches_cohort=launches["kmeans_assign_batched"]
         - after_sweep,
         single_launches=launches["kmeans_assign"],
         ratios={f"{a}/{m}/K={k}/scenario={s}": r["ratio"]
                 for (a, m, k, s), r in timing.items()},
         peak_live_bytes={f"{a}/{m}/rings={r}": p["peak_live_bytes"]
                          for (a, m, r), p in peaks.items()},
         cohort_peak_live_bytes=cohort["peak_live_bytes"],
         sweep_max_arm_utility_diff=sweep, card=card_line())
    return {"kmeans_assign": launches["kmeans_assign"],
            "kmeans_assign_batched": solo,
            "kmeans_assign_batched_cells": cells}


# -- phase 4g: the paper's figures --------------------------------------------

# the reference's "high H" for Fig. 3's async claim: the H values above 6
FIG3_HIGH_H = 9.0
# fig3's runs rerun on the CPU: H = 6, seed 0, every algorithm
FIG3_CROSS = (6.0, 0)


def fig3_claims(rows) -> dict:
    """``benchmarks/fig3_heterogeneity.py:7-11`` as booleans, per workload:
    the metric falls with H (each algorithm lower at the largest H than at
    the smallest), OL4EL beats AC-sync and Fixed-I (at every H the better
    OL4EL row above the better baseline), sync wins at H <= 5 and async at
    H >= 9."""
    out = {}
    for w in ("svm", "kmeans"):
        m = {(r["algo"], r["H"]): r["metric"] for r in rows
             if r["workload"] == w}
        hs = sorted({h for _, h in m})
        algos = sorted({a for a, _ in m})
        def ol(h):
            return max(m["ol4el-sync", h], m["ol4el-async", h])

        def base(h):
            return max(m["ac_sync-sync", h], m["fixed_i-sync", h])
        out[w] = {
            "metric_falls_with_h": all(m[a, hs[-1]] < m[a, hs[0]]
                                       for a in algos),
            "ol4el_beats_ac_sync_and_fixed_i": all(ol(h) > base(h)
                                                   for h in hs),
            "sync_wins_at_h_le_5": all(
                m["ol4el-sync", h] >= m["ol4el-async", h]
                for h in hs if h <= 5.0),
            "async_wins_at_high_h": all(
                m["ol4el-async", h] > m["ol4el-sync", h]
                for h in hs if h >= FIG3_HIGH_H)}
    return out


def fig4_claims(rows) -> dict:
    """``benchmarks/fig4_tradeoff.py:3-6``: OL4EL (the better of sync and
    async) at or above AC-sync at every consumption fraction; OL4EL-async
    the highest final metric."""
    out = {}
    for w in ("svm", "kmeans"):
        m = {(r["algo"], r["consumption_frac"]): r["metric"] for r in rows
             if r["workload"] == w}
        fracs = sorted({f for _, f in m})
        finals = {a: v for (a, f), v in m.items() if f == fracs[-1]}
        out[w] = {
            "ol4el_dominates_ac_sync": all(
                max(m["ol4el-sync", f], m["ol4el-async", f])
                >= m["ac_sync-sync", f] for f in fracs),
            "ol4el_async_highest_final": finals["ol4el-async"]
            == max(finals.values())}
    return out


def fig5_claims(rows) -> dict:
    """``benchmarks/fig5_scalability.py:3-6``: OL4EL-async improves with
    edges (at every H higher at the most edges than at the fewest); sync
    worse than async at H = 15 (at every edge count)."""
    out = {}
    for w in ("svm", "kmeans"):
        m = {(r["algo"], r["n_edges"], r["H"]): r["metric"] for r in rows
             if r["workload"] == w}
        es = sorted({e for _, e, _ in m})
        hs = sorted({h for *_, h in m})
        out[w] = {
            "async_improves_with_edges": all(
                m["ol4el-async", es[-1], h] > m["ol4el-async", es[0], h]
                for h in hs),
            "sync_worse_than_async_at_h15": all(
                m["ol4el-sync", e, 15.0] < m["ol4el-async", e, 15.0]
                for e in es)}
    return out


def check_metrics(name: str, rows, keys) -> None:
    """Every metric of ``rows`` finite and in (0, 1]; every svm accuracy
    above 1/8 (the chance level of its 8 classes).  A Fig. 4 point before
    the run's first aggregation is 0 by the reference's reduction
    (``_best_at_fractions`` starts from 0), so only its final point is
    held to that."""
    import math
    for r in rows:
        for k in keys:
            if k not in r:
                continue
            v = r[k]
            check(math.isfinite(v) and 0.0 <= v <= 1.0,
                  f"figures {name}: {k} = {v} in {r}")
            if r.get("consumption_frac", 1.0) < 1.0:
                continue
            svm = r.get("workload", "svm") == "svm" and k != "oracle_frac"
            check(v > (1.0 / 8.0 if svm else 0.0),
                  f"figures {name}: {k} = {v} in {r}")


def figures_phase() -> dict:
    """The paper's figures through ``repro_torch.bench`` at the ``--full``
    sizes with seed 0 only, each figure timed and its kernel launches
    counted; then fig3's H = 6, seed-0 runs again on the CPU from the
    same init."""
    import numpy as np
    import torch
    from repro_torch.bench import (churn_baselines, common,
                                   fig3_heterogeneity, fig4_tradeoff,
                                   fig5_scalability, policy_ablation,
                                   testbed)
    from repro_torch.bench import run as bench_run
    from repro_torch.data import make_traffic_dataset, make_wafer_dataset

    kw3, kw4, kw5 = (dict(kw, seeds=(0,))
                     for kw in bench_run.sizes(full=True))
    fig3_runs, fig5_run_s, last = [], {}, [0.0]

    def keep3(r):
        if (r.heterogeneity, r.seed) == FIG3_CROSS:
            fig3_runs.append(r)

    def time5(r):                    # each run's seconds, set-up included
        now = time.perf_counter()
        fig5_run_s.setdefault(f"{r.workload}:{r.mode}:E={r.n_edges}",
                              []).append(now - last[0])
        last[0] = now

    def fig5():
        last[0] = time.perf_counter()
        return fig5_scalability.run(**kw5, on_run=time5, quiet=True,
                                    device="cuda")

    n_h = len(kw3.get("h_values") or fig3_heterogeneity.H_VALUES)
    n_e = len(kw5.get("edge_counts") or fig5_scalability.EDGE_COUNTS)
    n_h5 = len(kw5.get("h_values") or fig5_scalability.H_VALUES)
    figures = [
        ("fig3", lambda: fig3_heterogeneity.run(
            **kw3, on_run=keep3, quiet=True, device="cuda"),
         2 * n_h * len(fig3_heterogeneity.ALGOS), ("metric",)),
        ("fig4", lambda: fig4_tradeoff.run(**kw4, quiet=True, device="cuda"),
         2 * len(fig4_tradeoff.ALGOS) * len(fig4_tradeoff.FRACTIONS),
         ("metric",)),
        ("fig5", fig5, 2 * n_e * n_h5 * 2, ("metric",)),
        ("policies", lambda: policy_ablation.run(quiet=True, device="cuda"),
         len(policy_ablation.POLICIES) + 3, ("oracle_frac", "svm_acc")),
        ("churn", lambda: churn_baselines.run(quiet=True, device="cuda"),
         3 * len(churn_baselines.DEFAULT_RATES), ("metric",)),
        ("testbed", lambda: testbed.run(quiet=True, device="cuda"),
         len(testbed.ALGOS), ("metric",))]
    card = card_line()

    # the main path, counts read around it: every figure, one after another
    reset_counts()
    torch.cuda.synchronize()
    result, before = {}, counts()
    for name, fn, n_rows, keys in figures:
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        now = counts()
        result[name] = {"rows": rows, "seconds": secs, "kernel_launches": {
            k: now[k] - before[k] for k in now}}
        before = now
        check(len(rows) == n_rows,
              f"figures {name}: {len(rows)} rows, the reference has {n_rows}")
        check_metrics(name, rows, keys)
    launches = counts()
    check(launches["kmeans_assign"] > 0 and launches["ssd_scan"] == 0 and
          launches["flash_attention"] == 0,
          f"figures: unexpected kernel launches {launches}")

    claims = {"fig3": fig3_claims(result["fig3"]["rows"]),
              "fig4": fig4_claims(result["fig4"]["rows"]),
              "fig5": fig5_claims(result["fig5"]["rows"])}
    for name, r in result.items():
        rows = [{k: v for k, v in row.items() if k != "decisions"}
                for row in r["rows"]]             # the testbed's decisions
        emit("figures", figure=name, device="cuda", rows=rows,
             n_rows=len(r["rows"]), seconds=r["seconds"],
             kernel_launches=r["kernel_launches"],
             claims=claims.get(name), card=card)
    emit("figures_fig5_run_s", device="cuda",
         mean_s={k: float(np.mean(v)) for k, v in fig5_run_s.items()},
         max_s={k: float(np.max(v)) for k, v in fig5_run_s.items()},
         card=card)

    # the churn grid's svm seed-means beside the JAX package's record
    ref_rows = json.loads((ROOT / "BENCH_churn_baselines.json").read_text())
    ref_rows = {(r["policy"], r["churn_rate"]): r for r in ref_rows["rows"]}
    churn_diff = 0.0
    for r in result["churn"]["rows"]:
        ref = ref_rows[r["policy"], r["churn_rate"]]
        churn_diff = max(churn_diff, abs(r["metric"] - ref["metric"]))
        check(abs(r["metric"] - ref["metric"]) <= 0.05,
              f"figures churn {r['policy']} rate {r['churn_rate']}: "
              f"accuracy {r['metric']} vs the reference's {ref['metric']}")

    # fig3's H = 6, seed-0 runs on the CPU from the card runs' init
    h, seed = FIG3_CROSS
    check(len(fig3_runs) == 2 * len(fig3_heterogeneity.ALGOS),
          f"figures fig3: {len(fig3_runs)} runs at H = {h}, seed {seed}")
    y = {"kmeans": make_traffic_dataset(n=kw3["n_data"], seed=seed)[1]["y"],
         "svm": make_wafer_dataset(n=kw3["n_data"], seed=seed)[1]["y"]}
    cross = []
    for r in fig3_runs:
        cpu = common.run_el(r.workload, r.policy, r.mode, h,
                            budget=kw3["budget"], n_data=kw3["n_data"],
                            seed=seed,
                            init_params=common.default_init(r.workload, seed),
                            device="cpu")
        bound = (f1_flip_bound(y["kmeans"]) if r.workload == "kmeans"
                 else 1.0 / len(y["svm"]))
        same = ([(x.interval, x.edge) for x in r.records] ==
                [(x.interval, x.edge) for x in cpu.records]
                and r.arm_pulls == cpu.arm_pulls)
        cross.append({"workload": r.workload, "algo": f"{r.policy}-{r.mode}",
                      "same_decisions": same, "metric": r.final_metric,
                      "cpu_metric": cpu.final_metric, "flip_bound": bound,
                      "aggregations": r.n_aggregations,
                      "cpu_aggregations": cpu.n_aggregations})
        if r.workload == "kmeans":
            check(same and abs(r.final_metric - cpu.final_metric) <= bound,
                  f"figures fig3 kmeans {r.policy}-{r.mode} at H = {h}: "
                  f"card vs CPU {cross[-1]}")
    emit("figures_vs_cpu", figure="fig3", H=h, seed=seed, runs=cross,
         churn_max_diff_vs_reference=churn_diff, card=card)
    return {"kmeans_assign": launches["kmeans_assign"],
            "seconds": {k: r["seconds"] for k, r in result.items()},
            "claims": claims}


# -- phase 4i: the port's benches and bench gate -------------------------------

# the reference's micro rows (``benchmarks/microbench.py``), the kernel row
# after the E-step's plain one on a card
MICRO_ROWS = ["bandit_select_arm", "aggregate_1M_params_4edges",
              "xla_blocked_attention_b1_s512_d256",
              "kmeans_assign_ref_n4096_d64_k3", "kmeans_assign_n4096_d64_k3",
              "el_sim_svm_async_per_aggregation", "el_sync_host_per_round",
              "el_sync_ingraph_per_round", "el_telemetry_overhead_per_round",
              "el_async_host_per_event", "el_async_ingraph_per_event",
              "el_sweep_vmapped_4cells"]
MICRO_KERNEL_ROW = "kmeans_assign_n4096_d64_k3"
MICRO_SHAPE = (4096, 64, 3)                  # the E-step rows' inputs


def bench_gate(mode: str, argv: list) -> dict:
    """``bench_check`` in one mode: a contract or ledger regression (or a
    stale ledger entry), or what would be exit code 2, fails the run; the
    ratio and overhead findings are printed with their rows, ungated
    (this script gates correctness, not speed)."""
    from repro_torch.bench import bench_check
    from repro_torch.obs.regress import worst_exit_code
    args = bench_check.parser().parse_args(argv)
    try:
        found = bench_check.findings(args)
    except bench_check.MissingArtifact as e:
        fail(f"bench_check {mode}: exit code 2, missing {e}")
    except RuntimeError as e:
        fail(f"bench_check {mode}: exit code 2, {e}")
    for gate, f in found:
        if f.kind != "ok":
            print(f"bench_check {mode} ({gate}): {f}", flush=True)
    gated = [f for gate, f in found if gate in ("contract", "ledger")
             and f.kind in ("regression", "fixed")]
    check(not gated, f"bench_check {mode}: contract or ledger findings "
          f"{[str(f) for f in gated]}")
    return {"exit_code": worst_exit_code([f for _, f in found]),
            "findings": [{"gate": g, "kind": f.kind, "row": f.row,
                          "metric": f.metric, "detail": f.detail}
                         for g, f in found]}


def bench_phase() -> dict:
    """Phase 4i: (a) ``microbench.run`` on the card, the count set to 0
    just before and read just after; (b) ``bench_fleet`` at 16 tenants;
    (c) ``bench_check --smoke``; (d) ``bench_check`` on the committed
    baselines.  Each part's seconds."""
    import math
    import os
    import tempfile
    import torch
    from repro_torch.bench import bench_fleet, microbench
    card = card_line()
    seconds = {}

    # (a) the main path, counts read around it
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = microbench.run(quiet=True, device="cuda")
    torch.cuda.synchronize()
    seconds["micro"] = time.perf_counter() - t0
    launches = counts()
    check([r["name"] for r in rows] == MICRO_ROWS,
          f"bench micro: rows {[r['name'] for r in rows]}")
    for r in rows:
        check(math.isfinite(r["us_per_call"]) and r["us_per_call"] >= 0,
              f"bench micro: {r['name']} took {r['us_per_call']} us")
    krow = rows[MICRO_ROWS.index(MICRO_KERNEL_ROW)]
    check(krow["assign_mismatches"] == 0,
          f"bench micro: {krow['assign_mismatches']} assignments differ "
          "from the plain version's")
    check(krow["beyond_allowed"] == 0,
          f"bench micro: {krow['beyond_allowed']} distances outside "
          f"ref.allowed_error (max |d2 - d2_plain| {krow['max_abs_err']})")
    check(launches["kmeans_assign"] == krow["launches"] > 0 and
          launches["kmeans_assign_batched"] == 0 and
          launches["ssd_scan"] == 0 and launches["flash_attention"] == 0,
          f"bench micro: kernel launches {launches}, the row's "
          f"{krow['launches']}")
    emit("bench_micro", device="cuda", rows=rows,
         seconds=seconds["micro"], kernel_launches=launches, card=card)

    # (b) the fleet bench at 16 tenants (the script raises when fleet_16
    # and sequential_ingraph_16 disagree)
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "BENCH_torch_fleet.json")
        t0 = time.perf_counter()
        bench_fleet.main(["--tenants", "16", "--repeats", "1",
                          "--no-history", "--device", "cuda", "--out", out])
        torch.cuda.synchronize()
        seconds["fleet"] = time.perf_counter() - t0
        fleet = json.loads(Path(out).read_text())
    frows = fleet["rows"]
    check(frows["fleet_16"]["n_aggregations"] ==
          frows["sequential_ingraph_16"]["n_aggregations"] > 0,
          f"bench fleet: {frows}")
    emit("bench_fleet", device="cuda", rows=frows,
         seconds=seconds["fleet"], card=card)

    # (c) the smoke gate, (d) the gate on the committed baselines
    gates = {}
    for mode, argv in (("smoke", ["--smoke", "--no-history"]),
                       ("baselines", [])):
        t0 = time.perf_counter()
        gates[mode] = bench_gate(mode, argv)
        seconds[mode] = time.perf_counter() - t0
        emit("bench_check", mode=mode, seconds=seconds[mode],
             **gates[mode], card=card)
    emit("bench_phase", seconds=seconds,
         exit_codes={m: g["exit_code"] for m, g in gates.items()},
         card=card)
    return {"kmeans_assign": launches["kmeans_assign"], "seconds": seconds}


# -- phase 5: mamba2-370m serving ---------------------------------------------

# (arrival step, prompt length): three prompts open the first wave and
# leave a slot free; a short one arrives while they decode and is admitted
# mid-flight; four more arrive and take the slots the first wave frees
SERVE_TRAFFIC = [(0, 512), (0, 437), (0, 300), (3, 128),
                 (8, 200), (8, 480), (8, 256), (8, 333)]
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_NEW_TOKENS = 4, 1024, 16
# kernel vs plain SSD through the whole 48-layer model, as the largest
# difference over the largest magnitude of each compared tensor.  At f32
# the two differ by f32 summation order only: 1e-3.  At bf16 the kernel's
# y and the plain version's round to bf16 on either side of a boundary
# here and there (one ulp, 2^-8 relative), and 48 residual layers of
# random weights amplify that, so the kernel path is held to the bf16
# model's own rounding error measured in the same run: its distance from
# the plain path may not exceed the plain bf16 path's from the plain f32
# path.  (A fixed 5e-2 was tried first and missed: 0.054 logits, 0.059
# SSM state, 0.041 conv.)
SERVE_F32_TOL = 1e-3


class Timed:
    """Proxy of a model that times ``prefill`` / ``decode_step`` with the
    card synchronised around each call (host clock)."""

    def __init__(self, model):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.times = {"prefill": [], "decode": []}
        self.prefill_lens = []

    def _timed(self, key, fn, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        self.times[key].append(time.perf_counter() - t0)
        return out

    def init_cache(self, *args):
        return self.model.init_cache(*args)

    def prefill(self, params, tokens, cache):
        self.prefill_lens.append(int(tokens.shape[-1]))
        return self._timed("prefill", self.model.prefill, params, tokens,
                           cache)

    def decode_step(self, params, tokens, cache):
        return self._timed("decode", self.model.decode_step, params, tokens,
                           cache)


def drive_serving(model, params, prompts) -> dict:
    """``SERVE_TRAFFIC`` through the port's ``ServingEngine`` over
    ``model`` (timed): the main path, every kernel count set to 0 just
    before it and read just after."""
    import torch
    from repro_torch.serving import Request, ServingEngine

    timed = Timed(model)
    eng = ServingEngine(timed, params, n_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, seed=0)
    pending = list(enumerate(SERVE_TRAFFIC))
    done, mid_flight, step = [], [], 0
    submitted, token_times = {}, {uid: [] for uid in range(len(prompts))}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        while pending or eng.has_work():
            while pending and pending[0][1][0] <= step:
                uid, _ = pending.pop(0)
                eng.submit(Request(uid=uid, prompt=prompts[uid],
                                   max_new_tokens=SERVE_NEW_TOKENS))
                submitted[uid] = time.perf_counter()
            before = {r.uid for r in eng.slot_req if r is not None}
            was_active = eng.active
            finished = eng.step()      # ends in a host read of the tokens
            now = time.perf_counter()
            done += finished
            for r in eng.slot_req + finished:
                if r is not None:
                    token_times[r.uid] += [now] * (
                        len(r.output) - len(token_times[r.uid]))
            if was_active:       # requests that joined a running batch
                mid_flight += [r.uid for r in eng.slot_req + finished
                               if r is not None and r.uid not in before]
            step += 1
    torch.cuda.synchronize()
    return {"eng": eng, "timed": timed, "done": done,
            "mid_flight": mid_flight, "steps": step,
            "submitted": submitted, "token_times": token_times,
            "wall": time.perf_counter() - t0, "launches": counts(),
            "peak": torch.cuda.max_memory_allocated()}


def serve_result(cfg, n_params: int, init_s: float, run: dict) -> dict:
    """The phase line's fields of one serving run (``drive_serving``)."""
    timed, done = run["timed"], run["done"]
    new_tokens = sum(len(r.output) for r in done)
    decode_ms = [t * 1e3 for t in timed.times["decode"]]
    submitted, token_times = run["submitted"], run["token_times"]
    ttft_ms = sorted((token_times[u][0] - submitted[u]) * 1e3
                     for u in submitted)
    gaps_ms = sorted((b - a) * 1e3 for ts in token_times.values()
                     for a, b in zip(ts, ts[1:]))
    launches = run["launches"]
    return {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "dtype": cfg.dtype, "params": n_params, "init_s": init_s,
        "slots": SERVE_SLOTS, "requests": len(SERVE_TRAFFIC),
        "completed": len(done), "steps": run["steps"],
        "prefill_calls": len(timed.times["prefill"]),
        "prefill_lens": timed.prefill_lens,
        "prefill_ms": [t * 1e3 for t in timed.times["prefill"]],
        "decode_steps": len(decode_ms),
        "decode_ms_mean": sum(decode_ms) / max(len(decode_ms), 1),
        "decode_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
        "ttft_ms_median": ttft_ms[len(ttft_ms) // 2],
        "ttft_ms_max": ttft_ms[-1],
        "token_gap_ms_median": gaps_ms[len(gaps_ms) // 2],
        "token_gap_ms_max": gaps_ms[-1],
        "new_tokens": new_tokens, "wall_s": run["wall"],
        "tokens_per_s": new_tokens / run["wall"],
        "max_memory_allocated": run["peak"],
        "mid_flight_admitted": run["mid_flight"],
        "ssd_scan_launches": launches["ssd_scan"],
        "kmeans_assign_launches": launches["kmeans_assign"],
        "flash_attention_launches": launches["flash_attention"]}


def check_served(name: str, cfg, run: dict) -> None:
    outputs = {r.uid: r.output for r in run["done"]}
    check(len(run["done"]) == len(SERVE_TRAFFIC) and all(
        len(o) == SERVE_NEW_TOKENS for o in outputs.values()),
        f"{name}: not every request completed {SERVE_NEW_TOKENS} tokens")
    check(all(0 <= t < cfg.vocab_size for o in outputs.values() for t in o),
          f"{name}: token out of the vocabulary")
    check(len(run["mid_flight"]) >= 1,
          f"{name}: no request was admitted mid-flight")


def serve_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    from repro_torch.interop import tree_map
    from repro_torch.launch.serve import build

    cfg = get_config("mamba2-370m").model
    t0 = time.perf_counter()
    model, params, tokens = build(cfg, len(SERVE_TRAFFIC), 512, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.use_ssd_kernel, "mamba2 on CUDA must use the ssd_scan kernel")
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()), params)
    n_params = sum(sizes)
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's dt_bias [H] and the conv bias's 2N entries beyond it
    mc = cfg.mamba
    check(n_params == cfg.num_params() + cfg.n_layers * (
        mc.n_heads(cfg.d_model) + 2 * mc.d_state),
        f"mamba2-370m holds {n_params} parameters, not its full width")
    tokens = tokens.cpu().numpy()
    prompts = [tokens[i, :n] for i, (_, n) in enumerate(SERVE_TRAFFIC)]

    # the main path: every kernel count is read around exactly this run
    run = drive_serving(model, params, prompts)
    launches = run["launches"]["ssd_scan"]
    km_launches = run["launches"]["kmeans_assign"]
    fa_launches = run["launches"]["flash_attention"]
    n_prefill = len(run["timed"].times["prefill"])
    ssm = run["eng"].cache["groups"]["sub0"]["ssm"]
    emit("serve", **serve_result(cfg, n_params, init_s, run))
    check_served("serve", cfg, run)
    check(launches == cfg.n_layers * n_prefill and launches > 0,
          f"serve: ssd_scan launched {launches} times for {n_prefill} "
          f"prefills of {cfg.n_layers} layers")
    check(km_launches == 0 and fa_launches == 0,
          "serve: kmeans_assign or flash_attention launched")
    check(bool(torch.isfinite(ssm).all()), "serve: non-finite SSM cache")

    rel_err, agree, flips_outside = serve_vs_plain(cfg, params, prompts)
    emit("serve_vs_plain", rel_err=rel_err, f32_tol=SERVE_F32_TOL,
         first_token_agree=agree, first_tokens=len(prompts),
         flips_beyond_margin=flips_outside)
    for t in ("logits", "ssm", "conv"):
        check(rel_err[f"kernel_vs_plain_f32.{t}"] <= SERVE_F32_TOL,
              f"serve f32: kernel vs plain SSD off in {t}: {rel_err}")
        check(rel_err[f"kernel_vs_plain_bf16.{t}"]
              <= rel_err[f"bf16_vs_f32_plain.{t}"],
              f"serve bf16: kernel vs plain SSD in {t} beyond the bf16 "
              f"model's own rounding: {rel_err}")
    check(flips_outside == 0,
          "serve: a greedy first token flipped beyond the logits' error "
          "margin")
    del run, model, params
    torch.cuda.empty_cache()
    return {"ssd_scan": launches}


def ssd_paths():
    """Phase 5's pair: the ``ssd_scan`` kernel and the plain SSD, with the
    cache tensors each is compared on."""
    def tensors(cache):
        g = cache["groups"]["sub0"]
        return {"ssm": g["ssm"], "conv": g["conv"].float()}
    return {True: {"use_ssd_kernel": True},
            False: {"use_ssd_kernel": False}}, tensors


def attention_paths():
    """Phase 5b's pair: the ``flash_attention`` kernel fill and the naive
    fill, compared on every layer's K and V."""
    def tensors(cache):
        g = cache["groups"]["sub0"]
        return {"k": g["k"].float(), "v": g["v"].float()}
    return {True: {"attn_impl": "kernel"},
            False: {"attn_impl": "naive"}}, tensors


def left_padded(wave):
    """A wave of prompts (``[S]``, or ``[CB, S]`` with codebooks) as one
    int32 batch on the card, left-padded to the longest, as the engine
    pads them."""
    import numpy as np
    import torch
    s = max(p.shape[-1] for p in wave)
    return torch.from_numpy(np.stack([
        np.pad(p, [(0, 0)] * (p.ndim - 1) + [(s - p.shape[-1], 0)])
        for p in wave]).astype(np.int32)).to("cuda")


def serve_vs_plain(cfg, params, prompts, paths=None):
    """The prompts' prefill, kernel vs plain path (``ssd_paths()`` by
    default, or ``attention_paths()``), in waves of ``SERVE_SLOTS``, at
    the config's bf16 and at f32 (same weights).

    Returns the largest relative error of each pair and tensor
    (``{"kernel_vs_plain_bf16.logits": ..., ...}``), the first tokens the
    kernel and plain paths agree on per dtype, and the first-token flips
    beyond the logits' error margin."""
    import torch
    from repro_torch.models import build_model
    kwargs, tensors = paths or ssd_paths()
    models = {(dtype, kernel): build_model(
                  dataclasses.replace(cfg, dtype=dtype), device="cuda",
                  **kwargs[kernel])
              for dtype in ("bfloat16", "float32") for kernel in (True, False)}
    worst = {}                      # (pair name, tensor) -> relative error
    agree, flips_outside = {"bfloat16": 0, "float32": 0}, 0

    def rel(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    for w in range(0, len(prompts), SERVE_SLOTS):
        wave = prompts[w: w + SERVE_SLOTS]
        batch = left_padded(wave)
        out = {}
        for key, m in models.items():
            with torch.inference_mode():
                logits, cache = m.prefill(params, batch, m.init_cache(
                    len(wave), batch.shape[-1]))
            # the last position's logits ([B, V], or [B, CB, V])
            out[key] = {"logits": logits[..., -1, :].float(),
                        **tensors(cache)}
            del logits, cache
            for name, t in out[key].items():
                check(bool(torch.isfinite(t).all()),
                      f"serve compare {key}: non-finite {name}")
        names = list(out[key])
        pairs = {"kernel_vs_plain_f32": (("float32", True),
                                         ("float32", False)),
                 "kernel_vs_plain_bf16": (("bfloat16", True),
                                          ("bfloat16", False)),
                 "bf16_vs_f32_plain": (("bfloat16", False),
                                       ("float32", False))}
        for pname, (ka, kb) in pairs.items():
            for t in names:
                worst[pname, t] = max(worst.get((pname, t), 0.0),
                                      rel(out[ka][t], out[kb][t]))
        for dtype in agree:
            lk = out[dtype, True]["logits"]
            lp = out[dtype, False]["logits"]
            same = lk.argmax(-1) == lp.argmax(-1)
            top2 = lp.topk(2, dim=-1).values
            margin = top2[..., 0] - top2[..., 1]
            agree[dtype] += int(same.sum())
            flips_outside += int((~same & (margin > 2 * float(
                (lk - lp).abs().max()))).sum())
        del out
    rel_err = {f"{p}.{t}": v for (p, t), v in worst.items()}
    return rel_err, agree, flips_outside


# -- phase 5b: qwen3-1.7b serving ---------------------------------------------

# phase 5's traffic, slots and tolerances (SERVE_F32_TOL and its comment)
# on the dense model: every attention layer's prefill fills the KV cache
# through the flash_attention kernel, the decode attends over the cache
# in plain torch.  The kernel fill is held to the naive fill on the
# logits and on every layer's K and V.


SERVE_PROFILED_STEPS = 8


def serve_card_time(model, params, prompts) -> dict:
    """The first wave's prefill (its prompts left-padded to the longest)
    and ``SERVE_PROFILED_STEPS`` greedy decode steps after it, each under
    ``torch.profiler`` (``profile_busy``) after a warm-up; the decode's
    tokens stay on the card (the engine reads them back each step)."""
    import torch
    wave = prompts[:SERVE_SLOTS]
    batch = left_padded(wave)
    state = {}

    def next_input(logits):
        # greedy: [B, 1], or [B, CB, 1] with codebooks
        return logits[..., -1, :].argmax(-1)[..., None]

    def prefill():
        logits, state["cache"] = model.prefill(params, batch,
                                               state["cache"])
        state["tok"] = next_input(logits)

    def decode():
        for _ in range(SERVE_PROFILED_STEPS):
            logits, state["cache"] = model.decode_step(
                params, state["tok"], state["cache"])
            state["tok"] = next_input(logits)

    out = {"batch": len(wave), "prompt_len": int(batch.shape[-1]),
           "decode_steps": SERVE_PROFILED_STEPS}
    with torch.inference_mode():
        for name, fn in (("prefill", prefill), ("decode", decode)):
            state["cache"] = model.init_cache(len(wave), SERVE_MAX_LEN)
            if name == "decode":
                prefill()
            fn()                                     # warm-up
            state["cache"] = model.init_cache(len(wave), SERVE_MAX_LEN)
            if name == "decode":
                prefill()
            out[name] = profile_busy(fn)
    out["decode"]["kernels_per_step"] = \
        out["decode"]["kernels"] / SERVE_PROFILED_STEPS
    out["decode"]["ms_per_step"] = \
        out["decode"]["wall_ms"] / SERVE_PROFILED_STEPS
    return out


def serve_engine(cfg, name: str, want_params: int, extra=None,
                 reruns: int = 0):
    """``cfg`` at full width through ``launch/serve.build`` and the engine
    on phase 5's traffic (the main path, counted; the prompts ``[S]``, or
    ``[CB, S]`` with codebooks), its checks (``extra``: more fields for
    the phase line), then ``reruns`` more drives that must give the same
    greedy tokens, and past the counted run the first wave's card time.
    Returns (summary, params, prompts)."""
    import torch
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.serve import build

    t0 = time.perf_counter()
    model, params, tokens = build(cfg, len(SERVE_TRAFFIC), 512, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(model.attn_impl == "kernel" and model.use_ssd_kernel,
          f"{name}: on CUDA the fill must go through flash_attention and "
          "ssd_scan")
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == want_params,
          f"{name}: {cfg.name} holds {n_params} parameters, not its full "
          f"width's {want_params}")
    tokens = tokens.cpu().numpy()
    prompts = [tokens[i, ..., :n] for i, (_, n) in enumerate(SERVE_TRAFFIC)]
    # each attention layer's fill launches flash_attention once a prefill,
    # each Mamba layer's ssd_scan
    kinds = cfg.layer_kinds()
    per_prefill = {"flash_attention": kinds.count("attn"),
                   "ssd_scan": kinds.count("mamba")}

    # the main path: every kernel count is read around exactly this run
    run = drive_serving(model, params, prompts)
    launches = run["launches"]
    n_prefill = len(run["timed"].times["prefill"])
    first = {r.uid: r.output for r in run["done"]}
    cache = run["eng"].cache
    result = serve_result(cfg, n_params, init_s, run)
    result.update(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                  head_dim=cfg.resolved_head_dim, vocab=cfg.vocab_size,
                  codebooks=cfg.n_codebooks,
                  prompt_shape=list(prompts[0].shape[:-1]) + ["S"],
                  max_len=SERVE_MAX_LEN,
                  kv_cache_bytes=sum(t.numel() * t.element_size()
                                     for t in tree_leaves(cache)
                                     if t.dim()),
                  flash_launches_per_prefill=per_prefill["flash_attention"],
                  ssd_launches_per_prefill=per_prefill["ssd_scan"],
                  **(extra or {}))
    emit(name, **result)
    check_served(name, cfg, run)
    fa = launches["flash_attention"]
    for kernel, n in per_prefill.items():
        check(launches[kernel] == n * n_prefill,
              f"{name}: {kernel} launched {launches[kernel]} times for "
              f"{n_prefill} prefills of {n} such layers")
    check(fa > 0 and launches["kmeans_assign"] == 0,
          f"{name}: flash_attention not launched, or kmeans_assign was")
    check(all(bool(torch.isfinite(t).all()) for kv in layer_kv(
        cache, SERVE_MAX_LEN) for t in kv), f"{name}: non-finite KV cache")
    del run, cache
    for i in range(reruns):
        again = drive_serving(model, params, prompts)
        same = {r.uid: r.output for r in again["done"]} == first
        emit(f"{name}_rerun", run=i + 1, tokens_equal=same,
             prefill_ms=[t * 1e3 for t in again["timed"].times["prefill"]])
        check(same, f"{name}: greedy tokens changed on a re-run")
        del again
    torch.cuda.empty_cache()
    # past the counted run: where a wave's prefill and decode steps spend
    # the card's time
    emit(f"{name}_card_time", **serve_card_time(model, params, prompts))
    del model
    torch.cuda.empty_cache()
    return ({"flash_attention": fa, "ssd_scan": launches["ssd_scan"],
             "prefills": n_prefill,
             "prefill_ms": result["prefill_ms"],
             "decode_ms_median": result["decode_ms_median"],
             "max_memory_allocated": result["max_memory_allocated"]},
            params, prompts)


def check_fill_vs_plain(name: str, cfg, params, prompts) -> None:
    """The kernel fill against the naive fill on the prompts' prefill
    (``serve_vs_plain`` with ``attention_paths()``): logits and every
    layer's K and V within ``SERVE_F32_TOL`` at f32, within the bf16
    model's own rounding at bf16, no greedy first token flipped beyond
    the logits' error margin."""
    rel_err, agree, flips_outside = serve_vs_plain(cfg, params, prompts,
                                                   attention_paths())
    emit(f"{name}_vs_plain", rel_err=rel_err, f32_tol=SERVE_F32_TOL,
         first_token_agree=agree,
         first_tokens=len(prompts) * cfg.n_codebooks,
         flips_beyond_margin=flips_outside)
    for t in ("logits", "k", "v"):
        check(rel_err[f"kernel_vs_plain_f32.{t}"] <= SERVE_F32_TOL,
              f"{name} f32: kernel vs naive fill off in {t}: {rel_err}")
        check(rel_err[f"kernel_vs_plain_bf16.{t}"]
              <= rel_err[f"bf16_vs_f32_plain.{t}"],
              f"{name} bf16: kernel vs naive fill in {t} beyond the bf16 "
              f"model's own rounding: {rel_err}")
    check(flips_outside == 0,
          f"{name}: a greedy first token flipped beyond the logits' error "
          "margin")


def serve_attention_phase() -> dict:
    import torch
    from repro_torch.config import get_config

    cfg = get_config("qwen3-1.7b").model
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's q/k norm scales (2 * head_dim)
    summary, params, prompts = serve_engine(
        cfg, "serve_attention",
        cfg.num_params() + cfg.n_layers * 2 * cfg.resolved_head_dim)
    check_fill_vs_plain("serve_attention", cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    return summary


# -- phase 6: qwen3-1.7b training ------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 3, 8, 512
# kernel vs naive attention through the whole 28-layer model from the same
# weights and batch: the logits of a forward pass (largest difference over
# largest magnitude), and one step's loss and gradient norm (relative).
# At f32 the two differ by f32 summation order only: 1e-3.  At bf16 the
# kernel rounds the unnormalised probabilities to bf16 where the plain
# version rounds the normalised ones, so the kernel path is held to the
# bf16 model's own rounding, measured in the same run: its logits and
# gradient norm may lie no further from the naive path's than the naive
# bf16 path's lie from the naive f32 path's.  The loss is a mean of
# per-token NLLs, each of which moves by at most twice the largest logit
# change (the log-softmax's gradient has L1 norm <= 2), so the bf16 loss
# gap is held to twice the logits' largest absolute difference.  (The
# first run held the bf16 loss to the naive bf16-vs-f32 loss gap and
# missed, 3.72e-5 against 3.57e-5: at random init the loss barely moves
# with bf16 rounding, which makes that gap no measure of it.)
TRAIN_F32_TOL = 1e-3


def train_args(arch="qwen3-1.7b", **kw):
    """The launcher's arguments (``launch.train.parse_args``) for a run on
    the card."""
    from repro_torch.launch.train import parse_args
    args = parse_args(["--arch", arch, "--device", "cuda",
                       "--log-every", "1"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    fa_ops.launches = km_ops.launches = ssd_ops.launches = 0
    km_ops.batched_launches = 0


def counts() -> dict:
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.kmeans_assign import ops as km_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    return {"flash_attention": fa_ops.launches,
            "kmeans_assign": km_ops.launches,
            "kmeans_assign_batched": km_ops.batched_launches,
            "ssd_scan": ssd_ops.launches}


def drive_training(exp, batch: int, seq: int,
                   kernel: str = "flash_attention", ckpt=None,
                   clean_batches=()) -> dict:
    """``launch.train.train_standard`` for ``TRAIN_STEPS`` steps at
    ``batch`` x ``seq``: the main path, every kernel count set to 0 just
    before it and read just after.  ``kernel`` is the one every layer's
    forward (and its remat recompute) launches, or ``"both"`` for a
    hybrid stack, whose attention layers launch ``flash_attention`` and
    whose Mamba layers ``ssd_scan``.  Returns the phase line's fields;
    with ``ckpt`` (the launcher's ``--ckpt``: the state is saved there
    after the steps) also the trained state, under ``"state"``.  Past the
    counted run, one clean step from the trained state at each batch size
    of ``clean_batches`` (``clean_step_peak``), under ``"clean_steps"``:
    the peaks phase 9 holds the planner to."""
    import torch
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.train import train_standard
    from repro_torch.train.state import make_train_step

    cfg = exp.model
    args = train_args(exp.model.name, steps=TRAIN_STEPS, batch=batch,
                      seq=seq, ckpt=ckpt)
    torch.cuda.synchronize()
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = train_standard(exp, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(out["state"].params)
    n_params = sum(t.numel() for t in leaves)
    finite = all(bool(torch.isfinite(t).all()) for t in leaves)
    step_ms = [t * 1e3 for t in out["step_s"]]
    median_ms = sorted(step_ms)[len(step_ms) // 2]
    result = {
        "arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, "remat": cfg.remat, "params": n_params,
        "batch": batch, "seq": seq, "steps": TRAIN_STEPS,
        "optimizer": exp.train.optimizer,
        "losses": [m["loss"] for m in out["metrics"]],
        "grad_norms": [m["grad_norm"] for m in out["metrics"]],
        "lrs": [m["lr"] for m in out["metrics"]],
        "step_ms": step_ms, "step_ms_median": median_ms,
        "tokens_per_s": batch * seq / (median_ms / 1e3),
        "wall_s": wall, "allocated_before": allocated_before,
        "max_memory_allocated": peak, "launches": launches,
        # with remat each layer's forward runs again in the backward
        "kernel": kernel,
        "kernel_launches_per_step": {
            k: 2 * n for k, n in layers_by_kernel(cfg, kernel).items()},
        "params_finite": finite}
    if clean_batches:
        state = out["state"]
        result["clean_steps"] = {
            b: clean_step_peak(cfg, lambda model, data: make_train_step(
                model, exp.train)(state, data), tree_leaves(state), b, seq)
            for b in clean_batches}
        del state
    if ckpt:
        result["state"] = out["state"]
    del out, leaves
    torch.cuda.empty_cache()
    return result


def clean_step_peak(cfg, step_fn, held, batch: int, seq: int) -> dict:
    """One clean step on the card for phase 9: ``step_fn(model, data)``
    on a fresh batch of ``batch`` x ``seq`` synthetic tokens (the model
    built as the planner builds it, over tensors the phase already holds:
    ``held``), between ``reset_peak_memory_stats()`` and
    ``max_memory_allocated()`` (``dryrun.measure_step``: the step's rise
    above what was allocated before it, plus its arguments' blocks).  The
    phase has just run the same path, so no warm-up."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import batch_struct
    model = dryrun.build(cfg, "cuda")
    data = dryrun.card_batch(cfg, batch_struct(cfg, batch, seq), "cuda",
                             torch.Generator(device="cuda").manual_seed(5))
    out = dryrun.measure_step(lambda: step_fn(model, data),
                              held + list(data.values()), repeats=1,
                              warmup=False)
    del data
    torch.cuda.empty_cache()
    return {"batch": batch, "seq": seq, "peak_bytes": out["peak_bytes"],
            "step_ms": out["step_ms"], "launches": out["launches"]}


def clean_prefill_peak(cfg, params, batch: int = 4, seq: int = 512) -> dict:
    """``clean_step_peak`` of ``make_prefill_step`` over ``params``."""
    from repro_torch.interop import tree_leaves
    from repro_torch.train.state import make_prefill_step
    return clean_step_peak(
        cfg, lambda model, data: make_prefill_step(model)(params, data),
        tree_leaves(params), batch, seq)


def layers_by_kernel(cfg, kernel: str) -> dict:
    """The layers of ``cfg`` that launch each kernel once a pass:
    ``kernel`` for every layer, or with ``"both"`` ``flash_attention``
    for the attention layers and ``ssd_scan`` for the Mamba layers."""
    if kernel != "both":
        return {kernel: cfg.n_layers}
    kinds = cfg.layer_kinds()
    return {"flash_attention": kinds.count("attn"),
            "ssd_scan": kinds.count("mamba")}


def check_trained(name: str, result: dict) -> None:
    import math
    losses = result["losses"]
    check(len(losses) == TRAIN_STEPS and all(math.isfinite(x)
                                             for x in losses)
          and result["params_finite"],
          f"{name}: non-finite loss or parameters: {losses}")
    launches = result["launches"]
    per_step = result["kernel_launches_per_step"]
    for kernel, n in per_step.items():
        check(launches[kernel] == n * TRAIN_STEPS and n > 0,
              f"{name}: {kernel} launched {launches[kernel]} times, not "
              f"{n} x {TRAIN_STEPS}")
    others = [k for k, n in launches.items() if n and k not in per_step]
    check(not others, f"{name}: {others} launched")


def train_phase() -> dict:
    from repro_torch.config import get_config

    exp = get_config("qwen3-1.7b")
    cfg = exp.model
    check(exp.train.global_batch == TRAIN_BATCH and exp.train.seq_len ==
          TRAIN_SEQ and exp.train.optimizer == "adamw" and cfg.remat,
          "qwen3-1.7b: the experiment's batch, sequence, optimizer or "
          "remat changed")
    # the main path: every kernel count is read around exactly this run
    result = drive_training(exp, TRAIN_BATCH, TRAIN_SEQ)
    emit("train", **result)
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's q/k norm scales (2 * head_dim)
    check(result["params"] == cfg.num_params() + cfg.n_layers * 2
          * cfg.resolved_head_dim,
          f"qwen3-1.7b holds {result['params']} parameters, not its full "
          "width")
    check_trained("train", result)
    return {"flash_attention": result["launches"]["flash_attention"]}


# -- phase 6b: minicpm-2b training --------------------------------------------

# minicpm-2b at full width (40 layers, d_model 2304, 36 heads of 64: MHA,
# vocab 122,753, tied, bf16, remat) under its own Warmup-Stable-Decay
# schedule; B = 4 (the experiment's 8 would not leave room: 2.7e9 params
# x 16 B of f32 params, gradients and AdamW moments are 43.6 GB, and the
# logits of a step take 1 GB a copy in f32).  Its first steps' learning
# rates are the warmup's smallest, so the loss barely moves: the gate is
# finite losses and the reference's wsd rates at those steps.
MINICPM_BATCH, MINICPM_SEQ = 4, 512


def wsd_lr(train, step: int) -> float:
    """The reference's ``wsd`` rate at ``step`` in plain floats
    (``src/repro/train/optimizer.py``'s formula, independent of the
    port's tensors)."""
    warm = max(train.warmup_steps, 1)
    total = max(train.total_steps, 1)
    peak = train.peak_lr
    if step < warm:
        return peak * min(step + 1.0, warm) / warm
    start = total * train.decay_start_frac
    frac = min(max((step - start) / max(total - start, 1.0), 0.0), 1.0)
    return peak - (peak - peak * train.min_lr_ratio) * frac


def minicpm_train_phase() -> dict:
    from repro_torch.config import get_config

    exp = get_config("minicpm-2b")
    cfg = exp.model
    check(exp.train.schedule == "wsd" and exp.train.optimizer == "adamw"
          and cfg.remat and cfg.tie_embeddings and cfg.n_heads == 36
          and cfg.n_kv_heads == 36 and cfg.resolved_head_dim == 64,
          "minicpm-2b: the experiment's schedule, optimizer, remat, "
          "embeddings or heads changed")
    # the main path: every kernel count is read around exactly this run
    # (then clean steps at B = 4 and at the experiment's B = 8 for phase 9)
    result = drive_training(exp, MINICPM_BATCH, MINICPM_SEQ,
                            clean_batches=(MINICPM_BATCH,
                                           exp.train.global_batch))
    want_lrs = [wsd_lr(exp.train, i) for i in range(TRAIN_STEPS)]
    result.update(schedule=exp.train.schedule, reference_lrs=want_lrs)
    emit("train_minicpm", **result)
    # minicpm has no q/k norms: the tree is num_params() exactly
    check(result["params"] == cfg.num_params(),
          f"minicpm-2b holds {result['params']} parameters, not its full "
          "width")
    check_trained("train_minicpm", result)
    check(all(abs(g - w) <= 1e-6 * w
              for g, w in zip(result["lrs"], want_lrs)),
          f"train_minicpm: learning rates {result['lrs']}, not the wsd "
          f"schedule's {want_lrs}")
    return {"flash_attention": result["launches"]["flash_attention"],
            "step_ms_median": result["step_ms_median"],
            "max_memory_allocated": result["max_memory_allocated"],
            "clean_steps": result["clean_steps"]}


def train_vs_plain(arch: str = "qwen3-1.7b", batch_size: int = TRAIN_BATCH,
                   seq: int = TRAIN_SEQ, phase: str = "train_vs_plain",
                   kernel: str = "flash_attention",
                   f32_tol: dict = None, cfg=None) -> dict:
    """The kernel and the plain path (``kernel`` ``flash_attention``: the
    kernel and the naive attention; ``ssd_scan``: the kernel's SSD and
    ``ssd_reference``; ``"both"``: the two kernels against the two plain
    paths) through the whole model (``cfg``, default ``arch``'s), at f32
    and at the config's bf16, from the same weights and batch: a forward
    pass's logits, and one step's loss and gradient norm.  ``f32_tol``
    bounds each f32 gap (``TRAIN_F32_TOL`` by default).  The kernels'
    launches are counted in the forward pass, the loss's forward and the
    backward (each layer's remat recompute) apart.  With MoE layers the
    plain path takes the kernel path's expert choices, replayed call by
    call (``RoutingLog``: a choice at the top-k boundary may flip with
    f32 rounding, and the comparison is of the kernels, not of that)."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.interop import tree_map
    from repro_torch.models import LM
    from repro_torch.train import clip_by_global_norm

    f32_tol = f32_tol or {k: TRAIN_F32_TOL
                          for k in ("logits", "loss", "grad_norm")}
    path_kw = {"flash_attention": {"kernel": {"attn_impl": "kernel"},
                                   "naive": {"attn_impl": "naive"}},
               "ssd_scan": {"kernel": {"use_ssd_kernel": True},
                            "naive": {"use_ssd_kernel": False}},
               "both": HYBRID_PATHS}[kernel]
    cfg = cfg or get_config(arch).model
    per_pass = layers_by_kernel(cfg, kernel)
    replay = {}                    # dtype -> the kernel path's choices
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    batch = SyntheticLMData.for_model(cfg, batch_size, seq).batch(
        0, 0, device="cuda")
    out, logits = {}, {}
    for dtype in ("float32", "bfloat16"):
        for impl in ("kernel", "naive"):
            model = LM(dataclasses.replace(cfg, dtype=dtype), device="cuda",
                       **path_kw[impl])
            reset_counts()
            marks = [counts()]
            with RoutingLog(replay.get(dtype) if impl == "naive"
                            else None) as log:
                with torch.no_grad():
                    logits[dtype, impl] = model.forward(
                        params, batch["tokens"],
                        batch.get("prefix_emb"))[0].float()
                marks.append(counts())
                leaves = []

                def track(p):
                    leaves.append(p.detach().requires_grad_())
                    return leaves[-1]
                loss, metrics = model.loss(tree_map(track, params), batch)
                marks.append(counts())
                grads = torch.autograd.grad(loss, leaves)
                marks.append(counts())
            if impl == "kernel":
                replay[dtype] = log.idx
            _, gnorm = clip_by_global_norm(grads, 0.0)
            out[dtype, impl] = {"loss": float(metrics["loss"].detach()),
                                "grad_norm": float(gnorm),
                                "moe_calls": len(log.idx),
                                "launches": {
                                    k: dict(zip(("forward", "loss_forward",
                                                 "backward_recompute"),
                                                (b[k] - a[k] for a, b in
                                                 zip(marks, marks[1:]))))
                                    for k in per_pass}}
            del grads, loss, leaves
            torch.cuda.empty_cache()

    def gap(a, b):
        la, lb = logits[a], logits[b]
        res = {k: abs(out[a][k] - out[b][k]) / abs(out[b][k])
               for k in ("loss", "grad_norm")}
        res["logits"] = float((la - lb).abs().max()) / float(lb.abs().max())
        res["logits_abs"] = float((la - lb).abs().max())
        return res

    gaps = {"kernel_vs_naive_f32": gap(("float32", "kernel"),
                                       ("float32", "naive")),
            "kernel_vs_naive_bf16": gap(("bfloat16", "kernel"),
                                        ("bfloat16", "naive")),
            "bf16_vs_f32_naive": gap(("bfloat16", "naive"),
                                     ("float32", "naive"))}
    emit(phase, arch=arch, batch=batch_size, seq=seq, kernel=kernel,
         values={f"{d}.{i}": v for (d, i), v in out.items()},
         rel_gap=gaps, f32_tol=f32_tol)
    for (dtype, impl), v in out.items():
        # each pass runs every layer once: the forward, the loss's
        # forward, the remat recompute in the backward
        for k, n_layers in per_pass.items():
            want = n_layers if impl == "kernel" else 0
            check(all(n == want for n in v["launches"][k].values()),
                  f"{phase} {dtype} {impl}: {k} launched "
                  f"{v['launches'][k]} times, not {want} a pass")
    for k, tol in f32_tol.items():
        check(gaps["kernel_vs_naive_f32"][k] <= tol,
              f"{phase} f32: kernel vs plain {k} beyond {tol}: {gaps}")
    for k in ("logits", "grad_norm"):
        check(gaps["kernel_vs_naive_bf16"][k]
              <= gaps["bf16_vs_f32_naive"][k],
              f"{phase} bf16: kernel vs plain in {k} beyond the bf16 "
              f"model's own rounding: {gaps}")
    bf16 = gaps["kernel_vs_naive_bf16"]
    loss_n = out["bfloat16", "naive"]["loss"]
    check(bf16["loss"] * loss_n <= 2 * bf16["logits_abs"],
          f"{phase} bf16: the loss moved more than twice the largest logit "
          f"change: {gaps}")
    del params, logits
    torch.cuda.empty_cache()
    return gaps


# -- phases 5c / 5d: the MoE family serving -------------------------------------

# olmoe-1b-7b at full width and depth (16 layers, d_model 2048, 16 heads of
# 128 (MHA), qk-norm, 64 experts top-8 of d_ff 1024, vocab 50,304, untied,
# bf16; 5c) and deepseek-moe-16b at full width, its depth cut from 28 to 4
# layers because its 65.3 GB f32 tree would not fit safely beside the
# activations and per-layer casts on 80 GB (1 dense prefix layer, then 3
# MoE layers of 2 shared experts and 64 routed top-6 of d_ff 1408, vocab
# 102,400; 5d), each through the engine on phase 5's traffic after phase
# 6b's state is released.  The kernel fill is held to the naive fill at f32
# through the whole model.  A token at the top-k boundary of a layer's
# router can take another expert on either path (f32 rounding moves the
# router logits by ~1e-6), which moves its residual stream by an expert's
# output, and through a full expert's queue the drop decisions of other
# tokens (left-padded prompts send their pad rows to the same experts):
# so the two fills are first run free and their (token, layer) expert
# sets counted (at least MOE_AGREE of them must agree), then the naive
# fill runs again on the kernel fill's expert choices, replayed layer by
# layer (its own gates at those experts), and that pair is held to 1e-3
# on K, V and the last position's logits; the free pair's errors are
# reported beside it.  (The first card run held the free pair's K and V,
# less the rows of tokens whose sets differed, to 1e-3 and missed:
# 0.0228 and 0.0214, with 33 of 63,488 sets differing.)
MOE_AGREE = 0.999
# one MoE block at full width on the card and on the CPU: y and aux as
# the CPU tests hold them to the reference (absolute plus relative)
MOE_BLOCK_SHAPE = (4, 512)
MOE_Y_TOL, MOE_AUX_TOL = 1e-5, 1e-6


class RoutingLog:
    """While active, wraps ``repro_torch.models.moe.route``: every MoE
    layer's expert choices ([T, k]) in call order (``idx``).  With
    ``replay`` (such a list) each call takes the replayed layer's choices
    in place of its own top k, with its own probabilities' gates there,
    renormalized as ``route`` does."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.idx = moe, moe.route, []

        def route(router, xf, k):
            logits, probs, gate, idx = self.orig(router, xf, k)
            if self.replay is not None:
                idx = self.replay[len(self.idx)]
                gate = probs.gather(-1, idx)
                gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            self.idx.append(idx)
            return logits, probs, gate, idx
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def layer_kv(cache, s: int) -> list:
    """Every attention layer's (K, V) of a cache tree, positions [0, s),
    in f32: the unstacked prefix layers', then each group's (a Mamba
    layer's state has no K and V)."""
    out = [(c["k"][:, :s].float(), c["v"][:, :s].float())
           for c in cache.get("prefix_layers", []) if "k" in c]
    for sub in cache["groups"].values():
        if "k" in sub:
            out += [(k[:, :s].float(), v[:, :s].float()) for k, v in
                    zip(sub["k"].unbind(0), sub["v"].unbind(0))]
    return out


def layer_ssm(cache) -> list:
    """Every Mamba layer's (SSM state, conv state) of a stacked cache
    tree, in f32."""
    out = []
    for sub in cache["groups"].values():
        if "ssm" in sub:
            out += [(a.float(), c.float()) for a, c in
                    zip(sub["ssm"].unbind(0), sub["conv"].unbind(0))]
    return out


HYBRID_PATHS = {"kernel": {"attn_impl": "kernel", "use_ssd_kernel": True},
                "naive": {"attn_impl": "naive", "use_ssd_kernel": False}}


def moe_fill_vs_naive(cfg, params, prompts) -> dict:
    """The prompts' prefill in waves of ``SERVE_SLOTS`` at f32 (same
    weights), the kernel fill (``flash_attention``, and ``ssd_scan`` for
    Mamba layers) against the naive fill (naive attention, the plain
    SSD): run free, the (token, layer) expert sets that differ and the
    relative errors of the last position's logits, every attention
    layer's K and V and every Mamba layer's SSM and conv state
    (``free.*``); then the naive fill on the kernel fill's replayed expert
    choices, its errors (``replayed.*``)."""
    import torch
    from repro_torch.models import LM
    models = {impl: LM(dataclasses.replace(cfg, dtype="float32"),
                       device="cuda", **kw)
              for impl, kw in HYBRID_PATHS.items()}
    hybrid = "mamba" in cfg.layer_kinds()
    parts = ("logits", "k", "v") + (("ssm", "conv") if hybrid else ())
    sets = differ = 0
    err = {f"{run}.{t}": 0.0 for run in ("replayed", "free")
           for t in parts}
    for w in range(0, len(prompts), SERVE_SLOTS):
        wave = prompts[w: w + SERVE_SLOTS]
        s = max(len(p) for p in wave)
        batch = torch.tensor([[0] * (s - len(p)) + list(p) for p in wave],
                             dtype=torch.int32, device="cuda")
        out = {}
        for run, impl in (("kernel", "kernel"), ("free", "naive"),
                          ("replayed", "naive")):
            m = models[impl]
            replay = out["kernel"]["idx"] if run == "replayed" else None
            with torch.inference_mode(), RoutingLog(replay) as log:
                logits, cache = m.prefill(params, batch,
                                          m.init_cache(len(wave), s))
            out[run] = {"logits": logits[:, -1].float(),
                        "kv": layer_kv(cache, s), "idx": log.idx,
                        "ssm": layer_ssm(cache)}
            del logits, cache
            check(all(bool(torch.isfinite(t).all())
                      for kv in out[run]["kv"] + out[run]["ssm"] for t in kv)
                  and bool(torch.isfinite(out[run]["logits"]).all()),
                  f"moe fill {run}: non-finite logits or cache")
        for a, b in zip(out["kernel"]["idx"], out["free"]["idx"]):
            layer_differs = (a.sort(-1).values
                             != b.sort(-1).values).any(-1)
            sets += layer_differs.numel()
            differ += int(layer_differs.sum())
        for run in ("replayed", "free"):
            pairs = {"logits": [(out["kernel"]["logits"],
                                 out[run]["logits"])],
                     "k": [(a[0], b[0]) for a, b in
                           zip(out["kernel"]["kv"], out[run]["kv"])],
                     "v": [(a[1], b[1]) for a, b in
                           zip(out["kernel"]["kv"], out[run]["kv"])],
                     "ssm": [(a[0], b[0]) for a, b in
                             zip(out["kernel"]["ssm"], out[run]["ssm"])],
                     "conv": [(a[1], b[1]) for a, b in
                              zip(out["kernel"]["ssm"], out[run]["ssm"])]}
            for t in parts:
                for a, b in pairs[t]:
                    err[f"{run}.{t}"] = max(
                        err[f"{run}.{t}"],
                        float((a - b).abs().max()) / float(b.abs().max()))
        del out
    return {"rel_err": err, "f32_tol": SERVE_F32_TOL,
            "expert_sets": sets, "expert_sets_differ": differ,
            "expert_sets_agree": 1.0 - differ / sets}


def check_moe_fill(name: str, res: dict) -> None:
    check(res["expert_sets_agree"] >= MOE_AGREE,
          f"{name}: {res['expert_sets_differ']} of {res['expert_sets']} "
          f"(token, layer) expert sets differ between the kernel and the "
          f"naive fill")
    for key, v in res["rel_err"].items():
        if not key.startswith("replayed."):
            continue
        t = key.split(".", 1)[1]
        check(v <= SERVE_F32_TOL,
              f"{name} f32: kernel vs naive fill off in {t}: {res}")


def moe_block_vs_cpu(cfg, p) -> dict:
    """One MoE FFN (the block's ``p["ffn"]``, here layer 0's) at full
    width on a seeded f32 input [MOE_BLOCK_SHAPE, d] on the card and on
    the CPU, on the same weights."""
    import torch
    from repro_torch.models import moe
    d, k = cfg.d_model, cfg.moe.top_k
    x = torch.randn(*MOE_BLOCK_SHAPE, d,
                    generator=torch.Generator().manual_seed(5))
    p_cpu = {n: t.detach().cpu() for n, t in p.items()}
    out = {}
    with torch.inference_mode():
        for dev, pp in (("cuda", p), ("cpu", p_cpu)):
            xd = x.to(dev)
            y, aux = moe.moe_ffn(pp, cfg, xd)
            idx = moe.route(pp["router"], xd.reshape(-1, d), k)[3]
            out[dev] = (y.cpu(), {n: float(v) for n, v in aux.items()},
                        idx.cpu())
    (y_g, aux_g, idx_g), (y_c, aux_c, idx_c) = out["cuda"], out["cpu"]
    t = MOE_BLOCK_SHAPE[0] * MOE_BLOCK_SHAPE[1]
    cap = moe.capacity(t, cfg)
    kept = int(torch.bincount(idx_c.reshape(-1), minlength=cfg.moe
                              .num_experts).clamp_max(cap).sum())
    y_err = (y_g - y_c).abs()
    return {"shape": [*MOE_BLOCK_SHAPE, d], "experts": cfg.moe.num_experts,
            "top_k": k, "capacity": cap, "assignments": t * k,
            "dropped": t * k - kept,
            "expert_idx_equal": bool(torch.equal(idx_g, idx_c)),
            "y_max_abs_err": float(y_err.max()),
            "y_max_abs": float(y_c.abs().max()),
            "y_within_tol": bool((y_err <= MOE_Y_TOL
                                  + MOE_Y_TOL * y_c.abs()).all()),
            "aux_card": aux_g, "aux_cpu": aux_c,
            "aux_within_tol": all(abs(aux_g[n] - aux_c[n]) <= MOE_AUX_TOL
                                  + MOE_AUX_TOL * abs(aux_c[n])
                                  for n in aux_c)}


def serve_moe(cfg, name: str, reruns: int = 0) -> dict:
    """``cfg`` through ``serve_engine`` (phase 5's traffic, ``reruns``
    re-runs with the same greedy tokens, the first wave's card time), then
    layer 0's MoE block against the CPU, and the kernel fill against the
    naive fill at f32."""
    import torch
    from repro_torch.models.transformer import layer_groups
    m = cfg.moe
    prefix, group, _ = layer_groups(cfg)
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's q/k norm scales (2 * head_dim) where the model has them
    want = cfg.num_params() + (cfg.n_layers * 2 * cfg.resolved_head_dim
                               if cfg.qk_norm else 0)
    summary, params, prompts = serve_engine(
        cfg, name, want, reruns=reruns, extra={
            "experts": m.num_experts, "top_k": m.top_k,
            "expert_ffn_dim": m.expert_ffn_dim,
            "shared_experts": m.num_shared_experts,
            "prefix_layers": [list(b) for b in prefix]})
    # past the counted run: phase 9's clean prefill at the engine's shape
    summary["clean_step"] = clean_prefill_peak(cfg, params)
    first_moe = next(i for i, (_, f) in enumerate(group) if f == "moe")
    ffn = {n: t[0] for n, t in
           params["groups"][f"sub{first_moe}"]["ffn"].items()}
    block = moe_block_vs_cpu(cfg, ffn)
    emit(f"{name}_block_vs_cpu", **block, y_tol=MOE_Y_TOL,
         aux_tol=MOE_AUX_TOL)
    check(block["expert_idx_equal"] and block["y_within_tol"]
          and block["aux_within_tol"],
          f"{name}: the MoE block on the card is not the CPU's: {block}")
    del ffn
    torch.cuda.empty_cache()
    fill = moe_fill_vs_naive(cfg, params, prompts)
    emit(f"{name}_vs_plain", **fill)
    check_moe_fill(f"{name}_vs_plain", fill)
    del params
    torch.cuda.empty_cache()
    return summary


def serve_moe_phase() -> dict:
    from repro_torch.config import get_config
    cfg = get_config("olmoe-1b-7b").model
    m = cfg.moe
    check(cfg.n_layers == 16 and cfg.d_model == 2048 and m.num_experts == 64
          and m.top_k == 8 and cfg.n_heads == cfg.n_kv_heads == 16,
          "olmoe-1b-7b: the config's width or depth changed")
    return serve_moe(cfg, "serve_moe")


DEEPSEEK_MOE_LAYERS = 4


def serve_deepseek_phase() -> dict:
    from repro_torch.config import get_config
    from repro_torch.models import LM
    full = get_config("deepseek-moe-16b").model
    cfg = dataclasses.replace(full, n_layers=DEEPSEEK_MOE_LAYERS)
    model = LM(cfg, device="cuda")
    check(model.prefix == (("attn", "dense"),) and model.n_groups == 3
          and cfg.moe.num_shared_experts == 2 and cfg.moe.top_k == 6,
          f"deepseek-moe-16b at {DEEPSEEK_MOE_LAYERS} layers: not a dense "
          f"prefix layer and 3 MoE layers ({model.prefix}, {model.group})")
    emit("serve_deepseek_moe_cut", layers=[full.n_layers, cfg.n_layers],
         full_params=full.num_params(), cut_params=cfg.num_params(),
         reason="the full f32 tree (65.3 GB) does not fit safely on 80 GB "
                "beside activations and per-layer casts")
    return serve_moe(cfg, "serve_deepseek_moe", reruns=1)


# -- phase 6c: mamba2-370m training ---------------------------------------------

# mamba2-370m at full width and depth (48 layers, d_model 1024, 32 heads of
# 64, d_state 128, chunk 128, vocab 50,280, tied, bf16, remat) under the
# experiment's own TrainConfig (AdamW, B = 8, S = 512): every layer's SSD
# forward through the ssd_scan kernel, once in the forward and once more in
# its remat recompute (96 launches a step), the backward through the plain
# ssd_reference (the JAX package has no backward kernel).  Kernel vs plain
# SSD through the whole model at f32: the loss within 1e-5 and the gradient
# norm within 1e-4 (relative), the logits within TRAIN_F32_TOL.
MAMBA_F32_TOL = {"logits": TRAIN_F32_TOL, "loss": 1e-5, "grad_norm": 1e-4}


def mamba_train_phase() -> dict:
    from repro_torch.config import get_config
    exp = get_config("mamba2-370m")
    cfg = exp.model
    check(exp.train.global_batch == TRAIN_BATCH and exp.train.seq_len ==
          TRAIN_SEQ and exp.train.optimizer == "adamw" and cfg.remat,
          "mamba2-370m: the experiment's batch, sequence, optimizer or "
          "remat changed")
    # the main path: every kernel count is read around exactly this run
    result = drive_training(exp, TRAIN_BATCH, TRAIN_SEQ, kernel="ssd_scan")
    emit("train_mamba", **result)
    # num_params() is the reference's analytic count; the tree also holds
    # each layer's dt_bias [H] and the conv bias's 2N entries beyond it
    mc = cfg.mamba
    want = cfg.num_params() + cfg.n_layers * (mc.n_heads(cfg.d_model)
                                              + 2 * mc.d_state)
    check(result["params"] == want,
          f"mamba2-370m holds {result['params']} parameters, not {want}")
    check_trained("train_mamba", result)
    return {"ssd_scan": result["launches"]["ssd_scan"],
            "step_ms_median": result["step_ms_median"],
            "max_memory_allocated": result["max_memory_allocated"]}


# -- phases 6d / 6e: musicgen-medium and paligemma-3b training ---------------

# musicgen-medium at full width and depth (48 layers, d_model 1536, 24 heads
# of 64 (MHA), GeGLU d_ff 6144, 4 codebooks of vocab 2048: summed
# embeddings and a head per codebook, bf16, remat; 6d) under the
# experiment's own TrainConfig (AdamW, B = 8, S = 512, tokens [8, 4,
# 512]); paligemma-3b at full width (d_model 2048, 8 query heads of 256
# and 1 KV head, GeGLU d_ff 16,384, tied vocab 257,216, 256 prefix
# embeddings before the text, bf16, remat; 6e), its 18 layers cut to
# PALIGEMMA_TRAIN_LAYERS (at full depth the checkpoint's disk round trip,
# 30.1 GB written and read back, took ~125 s of the script's 1,200 s), at
# B = 4, S = 512 text tokens, the attention at (4, 768, 8, 1, 256).  Each
# after the previous phase's state is released; every attention layer's
# forward and remat recompute through flash_attention; then kernel vs
# naive attention through the whole model at f32 (loss 1e-5, gradient
# norm 1e-4, as 6c holds the SSD) and bf16.  6e then checks ``--ckpt``: the launcher saved
# the state after its steps; it is restored into a fresh template (each
# leaf's shape, dtype and device, no values) and must equal the live
# state bit for bit; one more step from each must give the same metrics
# and, leaf by leaf, the same bits (two int64 sums of each leaf's bit
# patterns, one position-weighted: the two states cannot share the card
# beside a step's gradients, so the restored one waits in host memory
# while the live one steps).
MULTIMODAL_F32_TOL = MAMBA_F32_TOL
PALIGEMMA_BATCH = 4
PALIGEMMA_TRAIN_LAYERS = 4


def musicgen_train_phase() -> dict:
    from repro_torch.config import get_config
    exp = get_config("musicgen-medium")
    cfg = exp.model
    check(exp.train.global_batch == TRAIN_BATCH and exp.train.seq_len ==
          TRAIN_SEQ and exp.train.optimizer == "adamw" and cfg.remat
          and cfg.n_layers == 48 and cfg.d_model == 1536
          and cfg.n_heads == cfg.n_kv_heads == 24
          and cfg.resolved_head_dim == 64 and cfg.n_codebooks == 4
          and cfg.vocab_size == 2048 and not cfg.tie_embeddings,
          "musicgen-medium: the config or the experiment's batch, sequence, "
          "optimizer or remat changed")
    # the main path: every kernel count is read around exactly this run
    result = drive_training(exp, TRAIN_BATCH, TRAIN_SEQ)
    result.update(codebooks=cfg.n_codebooks,
                  tokens_shape=[TRAIN_BATCH, cfg.n_codebooks, TRAIN_SEQ])
    emit("train_musicgen", **result)
    # num_params() is the reference's analytic count: one embedding table,
    # where the tree holds one a codebook
    want = cfg.num_params() + (cfg.n_codebooks - 1) * cfg.vocab_size \
        * cfg.d_model
    check(result["params"] == want,
          f"musicgen-medium holds {result['params']} parameters, not {want}")
    check_trained("train_musicgen", result)
    return {"flash_attention": result["launches"]["flash_attention"],
            "step_ms_median": result["step_ms_median"],
            "max_memory_allocated": result["max_memory_allocated"]}


def bit_digest(t) -> list:
    """Two int64 sums of a tensor's bit patterns, plain and weighted by
    position (mod 65,521), in chunks: equal tensors give equal digests."""
    import torch
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    bits = t.detach().contiguous().view(ints).reshape(-1)
    plain = weighted = 0
    for i in range(0, bits.numel(), 1 << 26):
        b = bits[i: i + (1 << 26)].long()
        w = torch.arange(i, i + b.numel(), device=b.device) % 65521 + 1
        plain += int(b.sum())
        weighted += int((b * w).sum())
    return [plain, weighted]


def ckpt_check(exp, result: dict, path: Path, batch_size: int) -> dict:
    """6e's ``--ckpt``: ``result["state"]`` (popped here, so that this
    function holds the live state's last reference) against the file the
    launcher wrote."""
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint, make_train_step

    state = result.pop("state")
    # a fresh template: each leaf's shape, dtype and device, one element
    template = tree_map(lambda t: torch.empty(
        (), dtype=t.dtype, device=t.device).expand(t.shape), state)
    step_at = checkpoint.latest_step(str(path))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = checkpoint.restore(str(path), template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    leaves = list(zip(tree_leaves(restored), tree_leaves(state)))
    unequal = sum(not (a.dtype == b.dtype and a.shape == b.shape
                       and a.device == b.device and torch.equal(a, b))
                  for a, b in leaves)
    del leaves
    # the restored state waits in host memory while the live one steps
    restored = tree_map(lambda t: t.cpu(), restored)
    torch.cuda.empty_cache()

    step = make_train_step(build_model(exp.model, device="cuda"), exp.train)
    batch = SyntheticLMData.for_model(exp.model, batch_size,
                                      TRAIN_SEQ).batch(0, step_at,
                                                       device="cuda")

    def one_more_step(s):
        reset_counts()
        s, metrics = step(s, batch)
        torch.cuda.synchronize()
        return {"metrics": {k: float(v) for k, v in metrics.items()},
                "digests": [bit_digest(t) for t in tree_leaves(s)],
                "flash_attention": counts()["flash_attention"]}

    live = one_more_step(state)
    del state
    torch.cuda.empty_cache()
    restored = tree_map(lambda t: t.to("cuda"), restored)
    again = one_more_step(restored)
    del restored
    torch.cuda.empty_cache()
    out = {"path": str(path.relative_to(ROOT)),
           "file_bytes": path.stat().st_size, "step": step_at,
           "restore_s": restore_s,
           # the launcher's wall time outside its steps: init and the save
           "save_and_init_s": result["wall_s"]
           - sum(result["step_ms"]) / 1e3,
           "leaves": len(live["digests"]),
           "leaves_unequal_after_restore": unequal,
           "next_step_metrics_live": live["metrics"],
           "next_step_metrics_restored": again["metrics"],
           "next_step_digests_equal": live["digests"] == again["digests"],
           "next_step_flash_attention": [live["flash_attention"],
                                         again["flash_attention"]]}
    path.unlink()
    return out


def paligemma_train_phase() -> dict:
    from repro_torch.config import get_config
    exp = get_config("paligemma-3b")
    cfg = exp.model
    check(exp.train.optimizer == "adamw" and cfg.remat
          and cfg.n_layers == 18 and cfg.d_model == 2048
          and cfg.n_heads == 8 and cfg.n_kv_heads == 1
          and cfg.resolved_head_dim == 256 and cfg.d_ff == 16384
          and cfg.vocab_size == 257216 and cfg.tie_embeddings
          and cfg.num_prefix_embeddings == 256,
          "paligemma-3b: the config, optimizer or remat changed")
    full = cfg
    cfg = dataclasses.replace(full, n_layers=PALIGEMMA_TRAIN_LAYERS)
    exp = dataclasses.replace(exp, model=cfg)
    emit("train_paligemma_cut", layers=[full.n_layers, cfg.n_layers],
         full_params=full.num_params(), cut_params=cfg.num_params(),
         reason="the checkpoint's disk round trip at full depth (30.1 GB "
                "written and read back) held ~125 s of the script's limit")
    path = ROOT / "build" / "paligemma_ckpt.npz"
    # the main path: every kernel count is read around exactly this run
    result = drive_training(exp, PALIGEMMA_BATCH, TRAIN_SEQ, ckpt=str(path))
    result.update(prefix_embeddings=cfg.num_prefix_embeddings,
                  attention_seq=cfg.num_prefix_embeddings + TRAIN_SEQ,
                  experiment_batch=exp.train.global_batch)
    emit("train_paligemma", **{k: v for k, v in result.items()
                                if k != "state"})
    # paligemma has no q/k norms: the tree is num_params() exactly
    check(result["params"] == cfg.num_params(),
          f"paligemma-3b at {cfg.n_layers} layers holds {result['params']} "
          "parameters, not its full width")
    check_trained("train_paligemma", result)
    ck = ckpt_check(exp, result, path, PALIGEMMA_BATCH)
    emit("train_paligemma_ckpt", **ck)
    check(ck["step"] == TRAIN_STEPS and ck["leaves_unequal_after_restore"]
          == 0, f"train_paligemma: --ckpt did not restore the state bit for "
          f"bit: {ck}")
    check(ck["next_step_metrics_live"] == ck["next_step_metrics_restored"]
          and ck["next_step_digests_equal"]
          and ck["next_step_flash_attention"] == [2 * cfg.n_layers] * 2,
          f"train_paligemma: a step from the restored state is not the "
          f"live state's: {ck}")
    return {"flash_attention": result["launches"]["flash_attention"],
            "step_ms_median": result["step_ms_median"],
            "max_memory_allocated": result["max_memory_allocated"]}


# -- phases 5e / 5f: musicgen-medium and paligemma-3b serving -----------------

# both at full width and depth through ``launch/serve.build`` and the engine
# on phase 5's traffic (SERVE_TRAFFIC, SERVE_SLOTS, SERVE_MAX_LEN,
# SERVE_NEW_TOKENS; mid-flight admission included) after 6e's state is
# released.  musicgen-medium's prompts are [4, S]: the engine samples every
# codebook, decodes [4 slots, 4, 1] and records codebook 0; the kernel fill
# is held to the naive fill as in 5b.  paligemma-3b is served on text
# prompts, as the reference's engine serves it (18 launches a prefill at
# (4, S, 8, 1, 256)); then ``LM.prefill`` with 256 prefix embeddings before
# 512 text tokens (18 launches at (4, 768, 8, 1, 256)) and 16 greedy
# decode steps against a cache of SERVE_MAX_LEN >= 256 + 512 + 16
# positions, and the kernel fill against the naive fill at f32 with the
# prefix: the last position's logits and every layer's K and V.
PREFIX_TEXT, PREFIX_DECODE = 512, 16


def serve_musicgen_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    cfg = get_config("musicgen-medium").model
    check(cfg.n_codebooks == 4 and cfg.n_layers == 48
          and cfg.n_heads == cfg.n_kv_heads == 24, "musicgen-medium: the "
          "config's codebooks, depth or heads changed")
    summary, params, prompts = serve_engine(
        cfg, "serve_musicgen", cfg.num_params() + (cfg.n_codebooks - 1)
        * cfg.vocab_size * cfg.d_model)
    check(prompts[0].shape == (cfg.n_codebooks, SERVE_TRAFFIC[0][1]),
          f"serve_musicgen: prompts of shape {prompts[0].shape}")
    check_fill_vs_plain("serve_musicgen", cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    return summary


def prefix_serving(cfg, params) -> dict:
    """``LM.prefill`` of ``SERVE_SLOTS`` sequences of 256 prefix
    embeddings and ``PREFIX_TEXT`` tokens (the synthetic stream's), then
    ``PREFIX_DECODE`` greedy decode steps: launches, ms, the cache index,
    and the kernel fill against the naive fill at f32."""
    import torch
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import LM

    n_prefix = cfg.num_prefix_embeddings
    check(SERVE_MAX_LEN >= n_prefix + PREFIX_TEXT + PREFIX_DECODE,
          "serve_paligemma: the cache cannot hold the prefix, the text and "
          "the decode")
    batch = SyntheticLMData.for_model(cfg, SERVE_SLOTS, PREFIX_TEXT).batch(
        0, 0, device="cuda")
    model = LM(cfg, device="cuda")
    with torch.inference_mode():
        cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN)
        torch.cuda.synchronize()
        # a main path: every kernel count is read around exactly this run
        reset_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch["tokens"], cache,
                                      batch["prefix_emb"])
        tok = logits[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_launches = counts()
        generated, decode_ms = [tok], []
        for _ in range(PREFIX_DECODE):
            t0 = time.perf_counter()
            logits, cache = model.decode_step(params, tok, cache)
            tok = logits[:, -1].argmax(-1)[:, None]
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) * 1e3)
            generated.append(tok)
        launches = counts()
    ids = torch.cat(generated, dim=1).cpu()
    k = cache["groups"]["sub0"]["k"]
    out = {"batch": SERVE_SLOTS, "prefix": n_prefix, "text": PREFIX_TEXT,
           "decode_steps": PREFIX_DECODE, "max_len": SERVE_MAX_LEN,
           "attention_shape": [SERVE_SLOTS, n_prefix + PREFIX_TEXT,
                               cfg.n_heads, cfg.n_kv_heads,
                               cfg.resolved_head_dim],
           "index": int(cache["index"]), "prefill_ms": prefill_ms,
           "decode_ms_median": sorted(decode_ms)[len(decode_ms) // 2],
           "prefill_launches": prefill_launches, "launches": launches,
           "ids_first_request": ids[0].tolist(),
           "kv_finite": bool(torch.isfinite(k[:, :, :n_prefix
                                             + PREFIX_TEXT]).all())}
    del model, cache, logits, k
    torch.cuda.empty_cache()
    check(out["index"] == n_prefix + PREFIX_TEXT + PREFIX_DECODE,
          f"serve_paligemma prefix: cache index {out['index']}")
    check(prefill_launches["flash_attention"] == cfg.n_layers
          and launches == prefill_launches
          and launches["ssd_scan"] == launches["kmeans_assign"] == 0,
          f"serve_paligemma prefix: launches {prefill_launches} in the "
          f"prefill, {launches} with the decode, not {cfg.n_layers} "
          "flash_attention")
    check(out["kv_finite"] and bool(((ids >= 0) & (ids < cfg.vocab_size))
                                    .all()),
          "serve_paligemma prefix: non-finite cache or ids out of the "
          "vocabulary")

    # the kernel fill against the naive fill at f32, with the prefix
    f32 = dataclasses.replace(cfg, dtype="float32")
    fills = {}
    for impl in ("kernel", "naive"):
        m = LM(f32, attn_impl=impl, device="cuda")
        with torch.inference_mode():
            logits, c = m.prefill(params, batch["tokens"], m.init_cache(
                SERVE_SLOTS, n_prefix + PREFIX_TEXT), batch["prefix_emb"])
        g = c["groups"]["sub0"]
        fills[impl] = {"logits": logits[:, -1].float(), "k": g["k"],
                       "v": g["v"]}
        del m, logits, c, g
        torch.cuda.empty_cache()
    out["kernel_vs_naive_f32"] = {
        t: float((fills["kernel"][t] - fills["naive"][t]).abs().max())
        / float(fills["naive"][t].abs().max()) for t in fills["kernel"]}
    del fills
    torch.cuda.empty_cache()
    return out


def serve_paligemma_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    cfg = get_config("paligemma-3b").model
    check(cfg.n_heads == 8 and cfg.n_kv_heads == 1
          and cfg.resolved_head_dim == 256 and cfg.tie_embeddings
          and cfg.num_prefix_embeddings == 256, "paligemma-3b: the config's "
          "heads, embeddings or prefix changed")
    # paligemma has no q/k norms: the tree is num_params() exactly
    summary, params, _ = serve_engine(cfg, "serve_paligemma",
                                      cfg.num_params())
    prefix = prefix_serving(cfg, params)
    emit("serve_paligemma_prefix", **prefix, f32_tol=SERVE_F32_TOL)
    check(all(v <= SERVE_F32_TOL
              for v in prefix["kernel_vs_naive_f32"].values()),
          f"serve_paligemma prefix f32: kernel vs naive fill beyond "
          f"{SERVE_F32_TOL}: {prefix['kernel_vs_naive_f32']}")
    del params
    torch.cuda.empty_cache()
    summary.update(prefix_flash_attention=prefix["prefill_launches"]
                   ["flash_attention"], prefix_prefill_ms=prefix["prefill_ms"],
                   prefix_decode_ms_median=prefix["decode_ms_median"])
    return summary


# -- phase 5g: jamba-1.5-large-398b serving -----------------------------------

# jamba-1.5-large-398b at full width (d_model 8192, 64 query and 8 KV heads
# of 128, d_ff 24,576, 16 experts top-2 of 24,576, Mamba-2 with 128 heads
# of 128 and d_state 128, chunk 128, vocab 65,536, untied, bf16), its depth
# cut from 72 layers to the three at positions 2-4 of its 8-layer group:
# (MAMBA, DENSE), (MAMBA, MOE), (ATTN, DENSE), every block kind of the full
# model and one MoE layer.  12.91 B parameters, a 51.6 GB f32 tree; the
# whole model's 1.59 TB, and the first 5 layers' 96.0 GB (two MoE layers),
# would not fit the card.  Phase 5's traffic through the engine (4 slots,
# 8 greedy requests of 16 tokens, prompts 128-512, mid-flight admissions at
# ragged lengths), re-run once for equal tokens; each prefill launches
# flash_attention once and ssd_scan twice (the bf16 instance at P = N =
# 128, P tile 64); then the kernel fill against the naive fill (naive
# attention, the plain SSD) at f32 by phase 5c's MoE rule, the Mamba
# layers' SSM and conv state compared too.  The layer-0 MoE block is not
# run on the CPU here: its 38.7 GB of f32 experts would take minutes
# there; 5c holds that code path's card and CPU results equal.
JAMBA = "jamba-1.5-large-398b"
JAMBA_CUT = {"n_layers": 3, "layer_pattern": ("mamba", "mamba", "attn"),
             "ffn_pattern": ("dense", "moe", "dense")}


def mamba_extra_params(cfg) -> int:
    """The tree's elements beyond ``num_params()`` (the reference's
    analytic count): each Mamba layer's dt_bias [H] and conv bias's 2N."""
    mc = cfg.mamba
    return cfg.layer_kinds().count("mamba") * (mc.n_heads(cfg.d_model)
                                               + 2 * mc.d_state)


def serve_jamba_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    from repro_torch.models import LM
    full = get_config(JAMBA).model
    cfg = dataclasses.replace(full, **JAMBA_CUT)
    m, mc = cfg.moe, cfg.mamba
    check(full.n_layers == 72 and full.d_model == 8192
          and full.n_heads == 64 and full.n_kv_heads == 8
          and full.resolved_head_dim == 128 and m.num_experts == 16
          and m.top_k == 2 and m.expert_ffn_dim == 24576
          and mc.n_heads(full.d_model) == 128 and mc.head_dim == 128
          and mc.d_state == 128
          and full.block_pattern()[2:5] == cfg.block_pattern(),
          f"{JAMBA}: the config's width or its layers 2-4 changed")
    model = LM(cfg, device="cuda")
    check(model.n_groups == 1 and model.group == cfg.block_pattern(),
          f"{JAMBA} cut: not one group of the three blocks: {model.group}")
    emit("serve_jamba_cut", layers=[full.n_layers, cfg.n_layers],
         kept=[list(b) for b in cfg.block_pattern()],
         full_params=full.num_params(), cut_params=cfg.num_params(),
         cut_f32_bytes=4 * (cfg.num_params() + mamba_extra_params(cfg)),
         reason="the full f32 tree (1.59 TB) and the first five layers' "
                "(96.0 GB, two MoE layers) do not fit on 80 GB; layers 2-4 "
                "hold every block kind and one MoE layer")
    summary, params, prompts = serve_engine(
        cfg, "serve_jamba", cfg.num_params() + mamba_extra_params(cfg),
        reruns=1, extra={
            "experts": m.num_experts, "top_k": m.top_k,
            "expert_ffn_dim": m.expert_ffn_dim, "ssm_heads": mc.n_heads(
                cfg.d_model), "ssm_head_dim": mc.head_dim,
            "d_state": mc.d_state,
            "blocks": [list(b) for b in cfg.block_pattern()]})
    # past the counted run: phase 9's clean prefill at the engine's shape
    summary["clean_step"] = clean_prefill_peak(cfg, params)
    fill = moe_fill_vs_naive(cfg, params, prompts)
    emit("serve_jamba_vs_plain", **fill)
    check_moe_fill("serve_jamba_vs_plain", fill)
    del params
    torch.cuda.empty_cache()
    return summary


# -- phase 5h: qwen3-1.7b at long context -------------------------------------

# qwen3-1.7b at full width with the sliding window the reference gives
# attention models at long context (``LONG_CONTEXT_WINDOW`` of the port's
# ``repro_torch.launch.specs``, the reference's value): 2 slots of 12,288-token prompts through the engine and
# 16 greedy decode steps, three ways: the masked full cache (12,304
# positions), ``window_slice`` (each decode step gathers the 8193 rows
# ending at its token) and ``ring_cache`` (8192 slots).  Every prefill goes
# through the kernel's window branch (28 launches at window 8192, by
# attention_fill, and by attention_fill_ring for the ring).  At the
# config's bf16 the masked run decodes freely and the other two decode
# the masked run's tokens (teacher-forced, so one flip does not carry):
# their logits are held to the bf16 rule of the serving phases (a
# variant's distance from the masked run no more than the masked run's own
# distance from the masked path at f32 on the same tokens), and a token
# of theirs may differ from the masked run's only where the masked run's
# top-2 margin is within twice their logits' difference.  (The first card
# run required the three runs' free bf16 tokens equal and missed: a
# near-tied greedy token of one slot flipped between the masked and the
# window_slice decode, each within the bf16 model's own rounding of the
# blocked path's logits over the whole sequence, and every later token
# then differed.)  At f32 the three runs decode freely and their tokens
# must be equal.
LONG_SLOTS, LONG_PROMPT, LONG_DECODE = 2, 12288, 16


class Logged(Timed):
    """``Timed`` that also keeps each call's last-position logits (f32);
    with ``forced`` ([B, steps] tokens) decode step i takes
    ``forced[:, i]`` as its input, whatever the engine sampled."""

    def __init__(self, model, forced=None):
        super().__init__(model)
        self.forced, self.logits = forced, []

    def prefill(self, params, tokens, cache):
        logits, cache = super().prefill(params, tokens, cache)
        self.logits.append(logits[:, -1].float())
        return logits, cache

    def decode_step(self, params, tokens, cache):
        if self.forced is not None:
            i = len(self.times["decode"])
            tokens = self.forced[:, i:i + 1]
        logits, cache = super().decode_step(params, tokens, cache)
        self.logits.append(logits[:, -1].float())
        return logits, cache


class FlashWindows:
    """While active, records the (S, window) of every ``flash_attention``
    kernel launch (wrapping the op's forward; its count is untouched)."""

    def __enter__(self):
        from repro_torch.kernels.flash_attention import ops
        self.ops, self.orig, self.windows = ops, ops._forward, []

        def forward(q, k, v, causal, window):
            if q.is_cuda:
                self.windows.append((int(q.shape[1]), window))
            return self.orig(q, k, v, causal, window)
        ops._forward = forward
        return self

    def __exit__(self, *exc):
        self.ops._forward = self.orig


LONG_VARIANTS = {"masked": {}, "window_slice": {"window_slice": True},
                 "ring": {"ring_cache": True}}


def long_context_run(cfg, params, prompts, kw, forced=None) -> dict:
    """The prompts through the engine over ``LM(cfg, **kw)`` (``Logged``,
    ``forced`` tokens if given), every kernel count set to 0 just before
    and read just after."""
    import torch
    from repro_torch.models import LM
    from repro_torch.serving import Request, ServingEngine
    logged = Logged(LM(cfg, device="cuda", **kw), forced)
    eng = ServingEngine(logged, params, n_slots=LONG_SLOTS,
                        max_len=LONG_PROMPT + LONG_DECODE)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p,
                           max_new_tokens=LONG_DECODE + 1))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.inference_mode(), FlashWindows() as fw:
        done = eng.run()
    launches = counts()
    decode_ms = sorted(t * 1e3 for t in logged.times["decode"])
    out = {"tokens": {r.uid: r.output for r in done},
           "logits": logged.logits, "launches": launches,
           "windows": sorted(set(fw.windows)),
           "prefill_ms": [t * 1e3 for t in logged.times["prefill"]],
           "decode_ms_median": decode_ms[len(decode_ms) // 2],
           "decode_steps": len(decode_ms),
           "cache_positions": int(eng.cache["groups"]["sub0"]["k"].shape[2]),
           "max_memory_allocated": torch.cuda.max_memory_allocated()}
    del eng, logged, done
    torch.cuda.empty_cache()
    return out


def serve_long_context_phase() -> dict:
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.specs import LONG_CONTEXT_WINDOW
    from repro_torch.models import LM
    cfg = dataclasses.replace(get_config("qwen3-1.7b").model,
                              sliding_window=LONG_CONTEXT_WINDOW)
    params = LM(cfg, device="cuda").init(
        torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (LONG_SLOTS, LONG_PROMPT),
                            generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32).numpy()
    max_len = LONG_PROMPT + LONG_DECODE

    def token_rows(tokens):
        return torch.tensor([tokens[u] for u in range(LONG_SLOTS)],
                            dtype=torch.int32, device="cuda")
    # the main path at bf16, each run counted: the masked run free, the
    # other two on its tokens
    runs = {"masked": long_context_run(cfg, params, prompts, {})}
    toks = runs["masked"]["tokens"]
    forced = token_rows(toks)
    for name in ("window_slice", "ring"):
        runs[name] = long_context_run(cfg, params, prompts,
                                      LONG_VARIANTS[name], forced)
    # past the counted runs: the masked path at f32 on the bf16 run's
    # tokens (the bf16 model's own rounding, the yardstick of the bf16
    # variants' logits), then the three ways at f32, free
    f32cfg = dataclasses.replace(cfg, dtype="float32")
    own_run = long_context_run(f32cfg, params, prompts, {}, forced)
    f32_runs = {name: long_context_run(f32cfg, params, prompts, kw)
                for name, kw in LONG_VARIANTS.items()}

    def rel(a, b):
        return max(float((x - y).abs().max()) / float(y.abs().max())
                   for x, y in zip(a, b))
    masked = runs["masked"]["logits"]
    own = rel(masked, own_run["logits"])
    gaps, flips, beyond = {}, {}, {}
    for name in ("window_slice", "ring"):
        got = runs[name]["logits"]
        gaps[name] = rel(got, masked)
        flips[name] = beyond[name] = 0
        # logits[i] chose token i (the prefill's the first)
        for i, (g, m) in enumerate(zip(got, masked)):
            top2 = m.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            differ = g.argmax(-1) != forced[:, i]
            flips[name] += int(differ.sum())
            beyond[name] += int((differ & (margin > 2 * float(
                (g - m).abs().max()))).sum())
    f32_toks = {name: r["tokens"] for name, r in f32_runs.items()}
    n_layers = cfg.n_layers
    result = {
        "arch": cfg.name, "layers": n_layers, "window": LONG_CONTEXT_WINDOW,
        "slots": LONG_SLOTS, "prompt_len": LONG_PROMPT,
        "decode_steps": LONG_DECODE, "bf16_vs_f32_masked": own,
        "vs_masked_bf16": gaps, "bf16_flips": flips,
        "bf16_flips_beyond_margin": beyond,
        "f32_tokens_equal": {name: f32_toks[name] == f32_toks["masked"]
                             for name in ("window_slice", "ring")},
        "f32_vs_masked": {name: rel(f32_runs[name]["logits"],
                                    f32_runs["masked"]["logits"])
                          for name in ("window_slice", "ring")},
        "f32_decode_ms_median": {name: r["decode_ms_median"]
                                 for name, r in f32_runs.items()},
        **{name: {k: v for k, v in r.items() if k not in ("tokens",
                                                          "logits")}
           for name, r in runs.items()}}
    emit("serve_long_context", **result)
    for name, r in runs.items():
        check(r["launches"]["flash_attention"] == n_layers
              and r["windows"] == [(LONG_PROMPT, LONG_CONTEXT_WINDOW)],
              f"serve_long_context {name}: flash_attention launches "
              f"{r['launches']} at (S, window) {r['windows']}, not "
              f"{n_layers} at ({LONG_PROMPT}, {LONG_CONTEXT_WINDOW})")
        check(r["launches"]["ssd_scan"] == 0
              and r["launches"]["kmeans_assign"] == 0,
              f"serve_long_context {name}: ssd_scan or kmeans_assign "
              "launched")
        check(len(r["tokens"]) == LONG_SLOTS and all(
            len(o) == LONG_DECODE + 1 for o in r["tokens"].values())
            and r["decode_steps"] == LONG_DECODE,
            f"serve_long_context {name}: not every request completed")
        check(all(bool(torch.isfinite(x).all()) for x in r["logits"]),
              f"serve_long_context {name}: non-finite logits")
    for rs in (runs, f32_runs):
        check(rs["ring"]["cache_positions"] == LONG_CONTEXT_WINDOW
              and rs["masked"]["cache_positions"] == max_len
              and rs["window_slice"]["cache_positions"] == max_len,
              "serve_long_context: cache lengths")
    for name in ("window_slice", "ring"):
        check(gaps[name] <= own,
              f"serve_long_context bf16: {name}'s logits {gaps[name]} from "
              f"the masked run's, beyond the bf16 model's own rounding {own}")
        check(beyond[name] == 0,
              f"serve_long_context bf16: {name} chose {beyond[name]} tokens "
              "other than the masked run's beyond the logits' error margin")
        check(f32_toks[name] == f32_toks["masked"],
              f"serve_long_context f32: {name}'s greedy tokens differ from "
              "the masked run's")
    del params, runs, f32_runs, own_run
    torch.cuda.empty_cache()
    return {"flash_attention": 3 * n_layers,
            "prefill_ms": result["masked"]["prefill_ms"]}


# -- phase 6f: the hybrid interleave trained at full width --------------------

# jamba-1.5-large-398b's interleave without MoE at full width: 2 layers,
# (MAMBA, DENSE) and (ATTN, DENSE) (2.85 B parameters: 45.6 GB of f32
# parameters, gradients and AdamW moments), the experiment's AdamW at
# S = 512 and B = HYBRID_TRAIN_BATCH (8, the larger of 4 and 8; it fits),
# 3 steps through ``launch.train.train_standard`` with remat: every step
# launches flash_attention twice and ssd_scan twice (forward and
# recompute); then kernel vs plain at f32 (loss 1e-5, gradient norm 1e-4)
# and bf16.  Training one MoE layer at full width needs at least 154 GB of
# state: it waits for several cards (ROADMAP item 14).  Then the smoke
# config on the full 8-layer pattern, two groups (16 layers, remat),
# kernel vs plain the same way, the plain path on the kernel path's
# replayed expert choices.
HYBRID_TRAIN_BATCH = 8
HYBRID_TRAIN_CUT = {"n_layers": 2, "layer_pattern": ("mamba", "attn"),
                    "ffn_pattern": ("dense", "dense")}


def train_hybrid_phase() -> dict:
    from repro_torch.config import get_config, get_smoke_config
    full = get_config(JAMBA)
    cfg = dataclasses.replace(full.model, **HYBRID_TRAIN_CUT)
    exp = dataclasses.replace(full, model=cfg)
    check(exp.train.optimizer == "adamw" and exp.train.seq_len == TRAIN_SEQ
          and cfg.remat and cfg.block_pattern() == (("mamba", "dense"),
                                                     ("attn", "dense")),
          f"{JAMBA}: the training cut's blocks or TrainConfig changed")
    # the main path: every kernel count is read around exactly this run
    result = drive_training(exp, HYBRID_TRAIN_BATCH, TRAIN_SEQ,
                            kernel="both",
                            clean_batches=(HYBRID_TRAIN_BATCH,))
    result.update(layers_full=full.model.n_layers,
                  blocks=[list(b) for b in cfg.block_pattern()],
                  moe_training="waits for several cards (ROADMAP item 14): "
                  "one MoE layer at full width needs >= 154 GB of state")
    emit("train_hybrid", **result)
    check(result["params"] == cfg.num_params() + mamba_extra_params(cfg),
          f"{JAMBA} training cut holds {result['params']} parameters")
    check_trained("train_hybrid", result)
    gaps = train_vs_plain(JAMBA, HYBRID_TRAIN_BATCH, phase=
                          "train_hybrid_vs_plain", kernel="both",
                          f32_tol=MAMBA_F32_TOL, cfg=cfg)
    smoke = get_smoke_config(JAMBA).model
    pattern = dataclasses.replace(
        smoke, layer_pattern=full.model.layer_pattern,
        ffn_pattern=full.model.ffn_pattern, n_layers=16, remat=True)
    smoke_gaps = train_vs_plain(JAMBA, phase="train_hybrid_smoke_vs_plain",
                                kernel="both", f32_tol=MAMBA_F32_TOL,
                                cfg=pattern)
    return {"flash_attention": result["launches"]["flash_attention"],
            "ssd_scan": result["launches"]["ssd_scan"],
            "step_ms_median": result["step_ms_median"],
            "max_memory_allocated": result["max_memory_allocated"],
            "clean_steps": result["clean_steps"],
            "vs_plain": gaps, "smoke_vs_plain": smoke_gaps}


# -- phase 7: ol4el over the LM ----------------------------------------------------

OL4EL_EDGES, OL4EL_BATCH, OL4EL_SEQ, OL4EL_ROUNDS = 2, 4, 128, 2


def ol4el_phase() -> dict:
    import math
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.train import train_ol4el

    exp = get_config("qwen3-1.7b")
    n_layers = exp.model.n_layers
    args = train_args(mode="ol4el", el_mode="sync", edges=OL4EL_EDGES,
                      batch=OL4EL_BATCH, seq=OL4EL_SEQ, steps=OL4EL_ROUNDS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: every kernel count is read around exactly this run
    reset_counts()
    t0 = time.perf_counter()
    rep = train_ol4el(exp, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    local_steps = int(sum(r.interval for r in rep.records)) * OL4EL_EDGES
    # one evaluation before the first round, one per round, one for the
    # report; each a forward of every layer (no remat without a backward)
    evals = rep.n_aggregations + 2
    want = 2 * n_layers * local_steps + n_layers * evals
    result = {"arch": exp.model.name, "mode": "sync", "edges": OL4EL_EDGES,
              "batch": OL4EL_BATCH, "seq": OL4EL_SEQ,
              "rounds": rep.n_aggregations,
              "intervals": [r.interval for r in rep.records],
              "local_steps": local_steps, "evaluations": evals,
              "losses": [r.metric for r in rep.records],
              "final_loss": rep.final_metric,
              "consumed": rep.total_consumed,
              "reason": rep.terminated_reason, "arm_pulls": rep.arm_pulls,
              "wall_s": wall, "max_memory_allocated": peak,
              "launches": launches, "flash_launches_expected": want}
    emit("ol4el", **result)
    check(rep.n_aggregations == OL4EL_ROUNDS
          and math.isfinite(rep.final_metric),
          f"ol4el: {rep.n_aggregations} rounds, final loss "
          f"{rep.final_metric}")
    check(launches["flash_attention"] == want,
          f"ol4el: flash_attention launched {launches['flash_attention']} "
          f"times, not {want}")
    check(launches["kmeans_assign"] == 0 and launches["ssd_scan"] == 0,
          "ol4el: kmeans_assign or ssd_scan launched")
    del rep
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"]}


# -- phase 9: the planner against the card -----------------------------------

# Each row plans one step on meta tensors (``repro_torch.launch.dryrun``)
# and holds its predicted peak to the peak the card measured around one
# clean step of the same step in the phase that already built that model
# (``clean_step_peak``), within PLAN_PEAK_TOL; a row the planner says does
# not fit is not run.  The timing row plans and measures qwen3-1.7b's
# prefill at phase 5b's shape (``plan_combo(measure=True)``: a warm-up,
# the median of 3) beside the port's roofline bound.
PLAN_PEAK_TOL = 0.15
PLAN_SHAPE = (4, 512)            # the engine's prefill: 4 slots of 512


def plan_row(name: str, plan: dict, measured=None, expect_fits=None) -> dict:
    """One phase-9 line: the plan's static bytes, predicted peak and
    verdict beside the card's measured peak (``None``: not run), checked."""
    mem = plan["memory"]
    row = {"row": name, "static_bytes": plan["static_bytes"],
           "predicted_peak_bytes": mem["peak_live_bytes"],
           "fits": plan["fits"], "flops": plan["cost"]["flops"],
           "bytes_accessed": plan["cost"]["bytes accessed"],
           "card": card_line()}
    if measured is not None:
        row.update(measured_peak_bytes=measured["peak_bytes"],
                   peak_error=mem["peak_live_bytes"] / measured["peak_bytes"]
                   - 1.0, clean_step_ms=measured["step_ms"])
    emit("planner", **row)
    if expect_fits is not None:
        check(plan["fits"] == expect_fits,
              f"planner {name}: fits={plan['fits']}, the card says "
              f"{expect_fits}")
    if measured is not None:
        check(plan["fits"], f"planner {name}: ran on the card but the plan "
              "says it does not fit")
        check(abs(row["peak_error"]) <= PLAN_PEAK_TOL,
              f"planner {name}: predicted {mem['peak_live_bytes']} bytes, "
              f"the card {measured['peak_bytes']} "
              f"({row['peak_error']:+.3f}, bound {PLAN_PEAK_TOL})")
    return row


def planner_phase(moe, deepseek, minicpm, jamba, hybrid) -> dict:
    import torch
    from repro_torch.bench import roofline
    from repro_torch.config import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    b, s = PLAN_SHAPE
    rows = [
        plan_row("olmoe-1b-7b prefill 4x512",
                 dryrun.plan_combo("olmoe-1b-7b", "prefill_32k", batch=b,
                                   seq_len=s), moe["clean_step"], True)]
    olmoe_train = dryrun.plan_combo("olmoe-1b-7b", "train_4k", batch=4,
                                    seq_len=s)
    rows.append(plan_row("olmoe-1b-7b train_step 4x512 (not run)",
                         olmoe_train, expect_fits=False))
    check(olmoe_train["static_bytes"] >= 110e9,
          f"planner: olmoe-1b-7b's training state is "
          f"{olmoe_train['static_bytes']} bytes, not >= 110 GB")
    rows.append(plan_row(
        f"deepseek-moe-16b prefill 4x512 layers 0:{DEEPSEEK_MOE_LAYERS}",
        dryrun.plan_combo("deepseek-moe-16b", "prefill_32k", batch=b,
                          seq_len=s, layers=f"0:{DEEPSEEK_MOE_LAYERS}"),
        deepseek["clean_step"], True))
    rows.append(plan_row(
        "deepseek-moe-16b prefill 4x512 full depth (not run)",
        dryrun.plan_combo("deepseek-moe-16b", "prefill_32k", batch=b,
                          seq_len=s)))
    for batch, clean in sorted(minicpm["clean_steps"].items()):
        rows.append(plan_row(
            f"minicpm-2b train_step {batch}x{MINICPM_SEQ}",
            dryrun.plan_combo("minicpm-2b", "train_4k", batch=batch,
                              seq_len=MINICPM_SEQ), clean, True))
    rows.append(plan_row(
        "jamba-1.5-large-398b prefill 4x512 layers 2:5",
        dryrun.plan_combo(JAMBA, "prefill_32k", batch=b, seq_len=s,
                          layers="2:5"), jamba["clean_step"], True))
    rows.append(plan_row(
        "jamba-1.5-large-398b prefill 4x512 layers 0:5 (not run)",
        dryrun.plan_combo(JAMBA, "prefill_32k", batch=b, seq_len=s,
                          layers="0:5"), expect_fits=False))
    cut = dataclasses.replace(get_config(JAMBA).model, **HYBRID_TRAIN_CUT)
    rows.append(plan_row(
        f"jamba-1.5 (MAMBA, DENSE), (ATTN, DENSE) train_step "
        f"{HYBRID_TRAIN_BATCH}x{TRAIN_SEQ}",
        dryrun.plan_model(cut, "train", HYBRID_TRAIN_BATCH, TRAIN_SEQ),
        hybrid["clean_steps"][HYBRID_TRAIN_BATCH], True))
    # the timing row: plan and measure qwen3-1.7b's prefill at 5b's shape
    timed = dryrun.plan_combo("qwen3-1.7b", "prefill_32k", batch=b,
                              seq_len=s, measure=True, device="cuda")
    roof = roofline.analyze(timed)
    step_s = timed["measured"]["step_ms"] / 1e3
    timing = {"row": "qwen3-1.7b prefill 4x512 --measure",
              "step_ms": timed["measured"]["step_ms"],
              "step_ms_all": timed["measured"]["step_ms_all"],
              "bound_s": roof["bound_s"], "dominant": roof["dominant"],
              "t_compute_s": roof["t_compute_s"],
              "t_memory_s": roof["t_memory_s"],
              "step_over_bound": step_s / roof["bound_s"],
              "predicted_peak_bytes": timed["memory"]["peak_live_bytes"],
              "measured_peak_bytes": timed["measured"]["peak_bytes"],
              "peak_error": timed["peak_error"],
              "launches": timed["measured"]["launches"],
              "kernels": timed["kernels"], "card": card_line()}
    emit("planner_timing", **timing)
    check(abs(timed["peak_error"]) <= PLAN_PEAK_TOL,
          f"planner qwen3-1.7b prefill: peak error {timed['peak_error']}")
    qwen = get_config("qwen3-1.7b").model
    check(timed["measured"]["launches"]["flash_attention"]
          == timed["measured"]["repeats"] * qwen.n_layers,
          f"planner --measure: flash_attention launched "
          f"{timed['measured']['launches']} times, not {qwen.n_layers} a "
          f"step")
    check(timed["kernels"]["flash_attention"]["flops"]
          == qwen.n_layers * fa_ops.work(
              b, s, qwen.n_heads, qwen.n_kv_heads,
              qwen.resolved_head_dim)[0],
          f"planner qwen3-1.7b prefill: kernel work {timed['kernels']}")
    torch.cuda.empty_cache()
    emit("planner_done", rows=len(rows) + 1,
         seconds=time.perf_counter() - t0)
    return {"rows": rows, "timing": timing}


# -- phase 9c: rank 0's share of the baseline steps on the production meshes --
# Four planner rows of ``dryrun --mesh pod|multipod`` that fit one card:
# rank 0's share of a train, a prefill and two decode steps (the batch-1
# long_500k decode, its K/V sequence split over the 16 edge ranks: 32,768
# positions a rank, or with ``--ring-cache`` the window's 8192 ring slots,
# 512 a rank), planned on meta and run on the card over a ``PlanMesh`` (every
# collective allocated as the ranks would allocate it, nothing exchanged:
# a gather copies the rank's block into every block) by
# ``dryrun.measure_model``, a warm-up then 3 clean steps (the train share,
# ~4.7 s a step: 1); each measured peak
# within PLAN_PEAK_TOL of the plan, each
# kernel of the row launched as often as its layers say, and each new
# kernel shape held to its plain version (the flash shape one (batch row,
# KV head) at a time, as phase 5h).
MESH_ROWS = (("qwen3-1.7b", "train_4k", "multipod", 1, False),
             ("mamba2-370m", "prefill_32k", "pod", 3, False),
             ("qwen3-1.7b", "long_500k", "pod", 3, False),
             ("qwen3-1.7b", "long_500k", "pod", 3, True))
FLASH_MESH_TRAIN = (8, 4096, 16, 8, 128, 0, "bfloat16")      # 8 rows a rank
SSD_MESH_PREFILL = (2, 32768, 32, 64, 128, 128, "bfloat16")  # 2 rows a rank


def mesh_plan_phase() -> dict:
    import torch
    from repro_torch.config import INPUT_SHAPES, get_config
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.launch.specs import adapt_model_for_shape
    t0 = time.perf_counter()
    card = card_line()
    rows, launches = [], {"flash_attention": 0, "ssd_scan": 0}
    for arch, shape, mesh, repeats, ring in MESH_ROWS:
        where = f"{arch} {shape} {mesh}" + (" ring_cache" if ring else "")
        row = dryrun.plan_combo(arch, shape, mesh=mesh, ring_cache=ring)
        check(row["fits"],
              f"phase 9c {where}: the plan says it does not "
              f"fit ({row['memory']['peak_live_bytes']} bytes)")
        spec = INPUT_SHAPES[shape]
        got = dryrun.measure_model(
            adapt_model_for_shape(get_config(arch).model, spec), spec.kind,
            spec.global_batch, spec.seq_len, "cuda", ring_cache=ring,
            mesh=PlanMesh.production(multi_pod=mesh == "multipod"),
            repeats=repeats)
        err = row["memory"]["peak_live_bytes"] / got["peak_bytes"] - 1.0
        n_layers = get_config(arch).model.n_layers
        if ring:
            from repro_torch.models import LM
            from repro_torch.train.layout import CacheLayout
            split = CacheLayout(LM(adapt_model_for_shape(
                get_config(arch).model, spec), device="meta",
                ring_cache=True), PlanMesh.production(), spec.global_batch,
                spec.seq_len).kv_split
            check(split is not None and split.n * row["edge_ranks"]
                  == row["sliding_window"],
                  f"phase 9c {where}: the ring is not split over the "
                  f"{row['edge_ranks']} edge ranks")
            ring_slots = split.n
        # a train step runs each layer's kernel in the forward and the
        # remat recompute; a prefill once; a decode none (plain attention
        # against the cache)
        want = {"train": 2 * n_layers, "prefill": n_layers,
                "decode": 0}[INPUT_SHAPES[shape].kind] * got["repeats"]
        kernel = "ssd_scan" if arch == "mamba2-370m" else "flash_attention"
        out = {"arch": arch, "shape": shape, "mesh": row["mesh"],
               "ring_cache": ring, "sliding_window": row["sliding_window"],
               "slots_a_rank": ring_slots if ring else None,
               "n_chips": row["n_chips"], "edge_ranks": row["edge_ranks"],
               "model_ranks": row["model_ranks"], "step": row["step"],
               "argument_bytes": row["memory"]["argument_size_in_bytes"],
               "predicted_peak_bytes": row["memory"]["peak_live_bytes"],
               "measured_peak_bytes": got["peak_bytes"], "peak_error": err,
               "step_ms": got["step_ms"], "step_ms_all": got["step_ms_all"],
               "launches": got["launches"], "flops": row["cost"]["flops"],
               "collective_bytes": row["collectives"]["bytes_per_device"],
               "collectives": {k: v["count"] for k, v in
                               row["collectives"]["per_op"].items()},
               "card": card}
        emit("mesh_plan", **out)
        check(abs(err) <= PLAN_PEAK_TOL,
              f"phase 9c {where}: predicted "
              f"{out['predicted_peak_bytes']} bytes, the card "
              f"{got['peak_bytes']} ({err:+.3f}, bound {PLAN_PEAK_TOL})")
        check(got["launches"][kernel] == want,
              f"phase 9c {where}: {kernel} launched "
              f"{got['launches']}, not {want}")
        check(row["collectives"]["bytes_per_device"] > 0,
              f"phase 9c {where}: no collective planned")
        for k in launches:
            launches[k] += got["launches"][k]
        rows.append(out)
    errs = {FLASH_MESH_TRAIN: flash_long_vs_plain(FLASH_MESH_TRAIN)}
    b, s, h, p, n, chunk, dt = SSD_MESH_PREFILL
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, dt, seed=311)
    y, state = ssd_ops.ssd(x, da, bm, cm, chunk)
    torch.cuda.synchronize()
    res = ssd_compare(y, state, x, da, bm, cm, chunk)
    emit("kernel_vs_plain", kernel="ssd_scan", b=b, s=s, h=h, p=p, n=n,
         chunk=chunk, dtype=dt, path="phase 9c", **res)
    for part in ("y", "state"):
        check(res[part]["finite"] and res[part]["beyond_allowed"] == 0,
              f"ssd_scan {part} off at {SSD_MESH_PREFILL}: {res[part]}")
    errs[SSD_MESH_PREFILL] = res["y"]["max_abs_err"]
    del x, da, bm, cm, y, state
    torch.cuda.empty_cache()
    emit("mesh_plan_done", rows=len(rows), launches=launches,
         seconds=time.perf_counter() - t0)
    return {"rows": rows, "errs": errs, **launches}


# -- phase 9b: the examples and the classic launcher on the card --------------

def examples_phase() -> dict:
    import tempfile
    import torch
    from repro_torch.examples import quickstart, serve_batched, \
        train_lm_ol4el
    from repro_torch.interop import tree_leaves
    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint
    out, t0 = {}, time.perf_counter()
    # each example and the launcher a main path of its own
    reset_counts()
    quick = quickstart.main(["--arch", "qwen3-1.7b", "--steps", "3"])
    out["quickstart"] = {"launches": counts(), "losses": quick["losses"]}
    check(out["quickstart"]["launches"]["flash_attention"] > 0
          and all(x == x for x in quick["losses"]),
          f"quickstart: {out['quickstart']}")
    reset_counts()
    served = serve_batched.main([])
    out["serve_batched"] = {"launches": counts(),
                            "archs": sorted(served)}
    check(out["serve_batched"]["launches"]["flash_attention"] > 0
          and out["serve_batched"]["launches"]["ssd_scan"] > 0,
          f"serve_batched: {out['serve_batched']}")
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/lm_ol4el.npz"
        reset_counts()
        rep = train_lm_ol4el.main(["--preset", "25m", "--rounds", "10",
                                   "--ckpt", path])
        launches = counts()
        back = checkpoint.restore(path, rep.final_params)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(back), tree_leaves(rep.final_params)))
        out["train_lm_ol4el"] = {
            "launches": launches, "aggregations": rep.n_aggregations,
            "final_loss": rep.final_metric, "restored_bit_equal": same}
        check(same and launches["flash_attention"] > 0
              and rep.n_aggregations > 0,
              f"train_lm_ol4el: {out['train_lm_ol4el']}")
        del rep, back
        # the 5m preset: 4 heads of 48, no instance's head dim (the f32
        # instance at D = 64 on zero-padded q, k and v)
        reset_counts()
        rep = train_lm_ol4el.main(["--preset", "5m", "--rounds", "10",
                                   "--ckpt", f"{tmp}/lm_5m.npz"])
        launches = counts()
        out["train_lm_ol4el_5m"] = {
            "launches": launches, "aggregations": rep.n_aggregations,
            "final_loss": rep.final_metric}
        check(launches["flash_attention"] > 0 and rep.n_aggregations > 0
              and rep.final_metric == rep.final_metric,
              f"train_lm_ol4el --preset 5m: {out['train_lm_ol4el_5m']}")
        del rep
    reset_counts()
    rep = launch_train.main(["--arch", "kmeans-traffic", "--mode", "ol4el",
                             "--el-mode", "sync", "--kmeans-impl", "cuda",
                             "--alpha", "1.0", "--budget", "5000",
                             "--steps", "64"])
    launches = counts()
    km = launches["kmeans_assign"] + launches["kmeans_assign_batched"]
    out["launch_train_kmeans"] = {
        "launches": launches, "aggregations": rep.n_aggregations,
        "final_f1": rep.final_metric}
    check(km > 0 and rep.n_aggregations > 0,
          f"launch.train kmeans-traffic: {out['launch_train_kmeans']}")
    torch.cuda.empty_cache()
    emit("examples", seconds=time.perf_counter() - t0, **out)
    return out


# -- phase 10: several ranks --------------------------------------------------

# Two gloo ranks share the one card (NCCL puts no two ranks of one
# communicator on one card); each is this script run as ``chip_smoke.py
# --rank <mode> <spec>`` by ``repro_torch.launch.hostdev.spawn_ranks`` and
# writes what it saw to ``build/ranks/``.  (a) the full-width kmeans-traffic
# and svm-wafer fixtures of phase 4b through ``run_sync_ingraph(mesh=)``
# (edges split 2 / 2, the edge stack all-gathered before the aggregation,
# chunks eager), bit for bit the unsharded card run on the card's own
# generator, its census, then donated; (b) ``local_sgd.make_el_round`` on
# mamba2-370m at full width (E = 2, h_max = 2, one edge a rank), bit for
# bit the one-rank run of both edges, each rank's peak held to the
# ``--step el_round`` plan; (c) an NCCL world of one: the sharded sync run
# issues no collective, (i) a captured NCCL gather, (ii) a sharded cell
# over a ``PlanMesh`` captured and eager; (e) with several cards, NCCL
# worlds of one rank a card whose sharded chunks are CUDA graphs.
RANKS = 2
RANKS_DIR = ROOT / "build" / "ranks"
RANK_TIMEOUT = 900
LM_ARCH = "mamba2-370m"
LM_EDGES, LM_H_MAX, LM_SEQ = 2, 2, 512
# a round's intervals: the first runs every edge's h_max steps (the round
# the plan plans), then one edge each
LM_INTERVALS = ((2, 2), (1, 2), (2, 1))
LM_WEIGHTS = (1.0, 3.0)
LM_EDGE_BATCH = 8              # per-edge batch, its plan checked to fit
LM_AXIS_LAYERS = "0:8"         # (d)'s layer window: 8 of mamba2-370m's 48
LM_CARD_SHARE = 0.8            # of the card both ranks' planned peaks may use


def rank_records(rep) -> list:
    return [[r.interval, r.n_aggregations, r.total_consumed, r.wall_time,
             r.metric, r.utility] for r in rep.records]


def same_floats(a, b) -> bool:
    import numpy as np
    return np.array_equal(np.asarray(a, np.float64), np.asarray(b, np.float64),
                          equal_nan=True)


def tree_digest(tree) -> list:
    from repro_torch.interop import tree_leaves
    return [bit_digest(t) for t in tree_leaves(tree)]


def lm_tokens(edge_batch: int, seq: int):
    import numpy as np
    from repro_torch.config import get_config
    vocab = get_config(LM_ARCH).model.vocab_size
    return np.random.default_rng(29).integers(
        0, vocab, (len(LM_INTERVALS), LM_EDGES, LM_H_MAX, edge_batch, seq),
        np.int32)


def lm_rounds(edge_batch: int, seq: int, mesh=None, layers=None) -> dict:
    """``make_el_round`` on mamba2-370m (the planner's model and AdamW; only
    its layer window ``layers``, ``a:b``, where given),
    ``LM_INTERVALS`` rounds over ``mesh`` (None: both edges here), the
    ``ssd_scan`` count set to 0 just before and read just after; the
    state's peak over the rounds (the rise over what was allocated, plus
    the arguments' blocks, as ``dryrun.measure_step`` reads it).  On one
    rank at a layer window also ``first_blocks``: after the first round,
    for each rank of (d)'s (1 x 2) mesh the digests of the state's slices
    that rank holds (``model_blocks``)."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_leaves
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import gather_edge_stack
    cfg = get_config(LM_ARCH).model
    if layers:
        cfg = dryrun.layer_window(cfg, layers)
    model = dryrun.build(cfg, "cuda")
    tc = dryrun._dryrun_train_cfg(edge_batch * LM_EDGES, seq)
    rnd = local_sgd.make_el_round(model, tc, LM_H_MAX, mesh=mesh)
    mine = rnd.edges(LM_EDGES)
    state = local_sgd.init_el_state(
        model, tc, LM_EDGES, torch.Generator(device="cuda").manual_seed(29),
        edges=mine)
    tokens = torch.from_numpy(lm_tokens(edge_batch, seq)[:, mine.start:mine.stop]
                              ).cuda()
    arg_bytes = dryrun.storages_bytes(tree_leaves(state) + [tokens[0]])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.launches = 0
    losses, secs, first_blocks = [], [], None
    for r, iv in enumerate(LM_INTERVALS):
        t0 = time.perf_counter()
        state, met = rnd(state, {"tokens": tokens[r]},
                         torch.tensor(iv, dtype=torch.int32, device="cuda"),
                         torch.tensor(LM_WEIGHTS, device="cuda"))
        losses.append(float(met["mean_loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if r == 0 and mesh is None and layers:
            first_blocks = [model_blocks(cfg, tc, state, i)
                            for i in range(RANKS)]
    launches = ssd_ops.launches
    peak = torch.cuda.max_memory_allocated() - base + arg_bytes
    params, gather_s = state.params, None
    if mesh is not None:           # the round's gather alone, once more
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = gather_edge_stack(params, mesh.edge_group())
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
    out = {"edges": [mine.start, mine.stop], "losses": losses,
           "round_s": secs, "gather_s": gather_s, "ssd_scan": launches,
           "peak_bytes": peak, "first_blocks": first_blocks,
           "digest": tree_digest(params),
           "finite": all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(params))}
    del state, params, tokens, model
    torch.cuda.empty_cache()
    return out


def model_blocks(cfg, tc, state, index: int) -> list:
    """The digests of the slices of a whole-leaf state (params and
    moments, every edge) that rank ``index`` of a 2-wide ``model`` axis
    holds: each leaf's block along the dim ``el_state_specs`` puts on
    ``model``, a replicated leaf whole, in ``tree_leaves`` order."""
    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_leaves
    from repro_torch.launch.mesh import PlanMesh
    from repro_torch.models import LM
    from repro_torch.sharding import map_specs
    from repro_torch.train.layout import model_dim
    shapes = local_sgd.init_el_state(LM(cfg, device="meta"), tc, LM_EDGES,
                                     None)
    specs = local_sgd.el_state_specs(cfg, PlanMesh(1, RANKS), shapes)
    dims = tree_leaves(map_specs(model_dim, specs))
    out = []
    for leaf, d in zip(tree_leaves(state), dims):
        if d is not None:
            n = leaf.shape[d] // RANKS
            leaf = leaf.narrow(d, index * n, n)
        out.append(bit_digest(leaf))
    return out


def lm_model_axis(edge_batch: int, seq: int, mesh) -> dict:
    """(d) on one rank of the (1 x 2) mesh: ``lm_rounds``' model at its
    ``LM_AXIS_LAYERS`` window, state and tokens, both edges, this rank's
    blocks (``init_el_state(mesh=)``),
    the first round only; the ``ssd_scan`` count set to 0 just before and
    read just after, the peak read as ``lm_rounds`` reads it, the digests
    of the rank's blocks, and (past the counted round) one pass of the
    model group's gathers over an edge's parameters, timed."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.federated import local_sgd
    from repro_torch.interop import tree_leaves, tree_map
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import dryrun
    cfg = dryrun.layer_window(get_config(LM_ARCH).model, LM_AXIS_LAYERS)
    model = dryrun.build(cfg, "cuda")
    tc = dryrun._dryrun_train_cfg(edge_batch * LM_EDGES, seq)
    rnd = local_sgd.make_el_round(model, tc, LM_H_MAX, mesh=mesh)
    mine = rnd.edges(LM_EDGES)
    state = local_sgd.init_el_state(
        model, tc, LM_EDGES, torch.Generator(device="cuda").manual_seed(29),
        edges=mine, mesh=mesh)
    tokens = torch.from_numpy(lm_tokens(edge_batch, seq)[0]).cuda()
    arg_bytes = dryrun.storages_bytes(tree_leaves(state) + [tokens])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ssd_ops.launches = 0
    t0 = time.perf_counter()
    state, met = rnd(state, {"tokens": tokens},
                     torch.tensor(LM_INTERVALS[0], dtype=torch.int32,
                                  device="cuda"),
                     torch.tensor(LM_WEIGHTS, device="cuda"))
    loss = float(met["mean_loss"])
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = ssd_ops.launches
    peak = torch.cuda.max_memory_allocated() - base + arg_bytes
    axis = local_sgd.model_axis(model, mesh)
    edge0 = tree_map(lambda a: a[0], state.params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in axis.full_leaves(edge0):
        pass
    torch.cuda.synchronize()
    gather_s = time.perf_counter() - t0
    out = {"edges": [mine.start, mine.stop], "losses": [loss],
           "round_s": round_s, "gather_pass_s": gather_s,
           "ssd_scan": launches, "peak_bytes": peak,
           "digest": tree_digest(state),
           "split": sum(a.shape != b.shape for a, b in zip(
               tree_leaves(state.params), tree_leaves(
                   local_sgd.init_el_state(dryrun.build(cfg, "meta"), tc,
                                           LM_EDGES, None).params))),
           "finite": all(bool(torch.isfinite(t).all())
                         for t in tree_leaves(state.params))}
    del state, edge0, tokens, model, rnd
    torch.cuda.empty_cache()
    return out


def sharded_classic(arch: str, mesh, want: dict) -> dict:
    """Phase 4b's session over ``mesh``: the sharded run (contract and
    profile on) on the card's generator, the kmeans_assign count set to 0
    just before and read just after, every batched launch's lane count
    recorded; then the same run donated."""
    import torch
    from repro_torch.interop import params_from_numpy
    from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.launch.classic import classic_fixture
    fx = classic_fixture(arch, samples=20000, n_edges=4, device="cuda")
    lanes, launch = [], ka_kernel.assign_fwd_batched

    def counted(x, *rest):
        lanes.append(int(x.shape[0]))
        return launch(x, *rest)
    ka_kernel.assign_fwd_batched = counted
    try:
        sess = compiled_session(fx, fx["init_params"])
        ka_ops.batched_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS, mesh=mesh,
                                    contract=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = ka_ops.batched_launches
    finally:
        ka_kernel.assign_fwd_batched = launch
    # past the counted run: the program again (profiled once, reused), and
    # the round's one collective alone
    t0 = time.perf_counter()
    again = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS, mesh=mesh)
    torch.cuda.synchronize()
    rerun_s = time.perf_counter() - t0
    gather_ms = None
    if mesh.size > 1:
        from repro_torch.launch.mesh import gather_edge_stack
        stack = {k: v.unsqueeze(0).expand(4 // mesh.size, *v.shape)
                 .contiguous() for k, v in again.final_params.items()}
        gather_edge_stack(stack, mesh.edge_group())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            gather_edge_stack(stack, mesh.edge_group())
        torch.cuda.synchronize()
        gather_ms = (time.perf_counter() - t0) / 50 * 1e3
    donated = params_from_numpy(want["init"], "cuda")
    dsess = compiled_session(fx, donated)
    drep = dsess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS, mesh=mesh,
                                  donate=True, contract=True)
    prof, dprof = rep.telemetry["profile"], drep.telemetry["profile"]
    return {"records": rank_records(rep), "digest": tree_digest(
        rep.final_params), "run_s": secs, "rerun_s": rerun_s,
        "rerun_same": same_floats(rank_records(again), rank_records(rep)),
        "gather_ms": gather_ms,
        "kmeans_assign_batched": launches, "lanes": sorted(set(lanes)),
        "collectives": prof["collectives"],
        "collective_bytes": prof["collective_bytes"],
        "alias_bytes": prof["alias_bytes"],
        "device_loop": rep.telemetry["device_loop"],
        "graphs_total": sess._fastpath.graphs_captured,
        "donated_loop": drep.telemetry["device_loop"],
        "donated_same": same_floats(rank_records(drep), rank_records(rep))
        and tree_digest(drep.final_params) == tree_digest(rep.final_params),
        "donated_alias_bytes": dprof["alias_bytes"],
        "donated_shares_storage": all(
            drep.final_params[k].data_ptr() == donated[k].data_ptr()
            for k in donated)}


def captured_gather(mesh, shapes: dict) -> dict:
    """10 (c) (i) on the NCCL world of one: ``gather_edge_stack`` over the
    world's edge group and the f32 mean of the gathered stack in edge
    order, on a rank's 2 edges of each leaf of ``shapes`` (svm-wafer's
    parameters); run eagerly on a side stream under the census (the
    warm-up, which also creates the communicator), captured into one CUDA
    graph, then replayed on fresh inputs, each replay against the same
    ops run eagerly on them; a replay's ms by CUDA events."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import gather_edge_stack
    from repro_torch.obs.prof import collective_census
    group = mesh.edge_group()
    gen = torch.Generator(device="cuda").manual_seed(31)

    def fresh():
        return {k: torch.randn((2,) + tuple(v), generator=gen,
                               device="cuda") for k, v in shapes.items()}

    def body(tree):
        out = {}
        for k, v in gather_edge_stack(tree, group).items():
            acc = v[0].clone()
            for e in range(1, v.shape[0]):
                acc = acc + v[e]
            out[k] = acc / v.shape[0]
        return out
    static = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        census, nbytes = collective_census(lambda: body(static),
                                           torch.device("cuda"))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        result = body(static)
    same, replays = True, 8
    for _ in range(replays):
        tree = fresh()
        for k, v in tree.items():
            static[k].copy_(v)
        graph.replay()
        want = body(tree)
        same = same and all(torch.equal(result[k], want[k]) for k in want)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(GATHER_REPS):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return {"same": same, "replays": replays, "collectives": census,
            "collective_bytes": nbytes,
            "stack_bytes": 2 * 4 * sum(int(np.prod(v))
                                       for v in shapes.values()),
            "replay_ms": start.elapsed_time(stop) / GATHER_REPS}


def planned_capture(init: dict) -> dict:
    """10 (c) (ii): phase 4b's full-width kmeans-traffic sync cell over a
    ``PlanMesh(2)`` (rank 0's 2 of 4 edges, its gathers copies: each
    ``PlannedGroup`` gather a device copy, nothing exchanged) on the
    card's generator, captured (a first run captures the chunk, a second
    replays it, the ``kmeans_assign`` count set to 0 just before and read
    just after), then the same cell with ``capturable=False``: every
    chunk eager."""
    import torch
    from repro_torch.el.ingraph import (SyncProgram, make_sync_program,
                                        sync_knobs)
    from repro_torch.el.rng import TorchDraws
    from repro_torch.interop import params_from_numpy
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.launch.classic import classic_fixture
    from repro_torch.launch.mesh import PlanMesh
    fx = classic_fixture("kmeans-traffic", samples=20000, n_edges=4,
                         device="cuda")
    cfg = compiled_session(fx, fx["init_params"]).cfg
    ex = fx["executor"]
    prog = make_sync_program(
        ex.model, ex.edge_data, ex.eval_set, cfg, lr=ex.lr, batch=ex.batch,
        n_samples=fx["n_samples"], metric_name=fx["metric"],
        max_rounds=COMPILED_ROUNDS, mesh=PlanMesh(2), device="cuda")
    eager = SyncProgram(dataclasses.replace(prog.cell, capturable=False),
                        prog.rounds_per_chunk)

    def run(p):
        params, out = p(params_from_numpy(init, "cuda"), sync_knobs(cfg),
                        TorchDraws(torch.Generator(device="cuda")
                                   .manual_seed(cfg.seed + 17)))
        return tree_digest(params), out_digest(out), int(out["n_rounds"])
    first = run(prog)
    capture_loop = dict(prog.last_run)
    ka_ops.batched_launches = 0
    got, secs = timed(lambda: run(prog))
    launches = ka_ops.batched_launches
    loop = dict(prog.last_run)
    want, eager_s = timed(lambda: run(eager))
    return {"same": got == want == first, "rounds": got[2],
            "sharded": prog.cell.sharded, "capturable": prog.cell.capturable,
            "capture_loop": capture_loop, "device_loop": loop,
            "eager_loop": dict(eager.last_run),
            "kmeans_assign_batched": launches, "run_s": secs,
            "eager_s": eager_s}


def lane_rounding() -> dict:
    """Why a sharded rank of one edge runs its lane beside a copy: the SVM
    step (batched GEMMs) at 4 lanes against its first lanes alone (1, 2,
    3) and against lane 0 beside a copy of itself, bit for bit; the lone
    lane is recorded, the others must agree."""
    import torch
    from repro_torch.config import get_config
    from repro_torch.models import build_model
    model = build_model(get_config("svm-wafer").model, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = {"w": torch.randn(4, 59, 8, generator=gen, device="cuda") * 0.1,
              "b": torch.randn(4, 8, generator=gen, device="cuda") * 0.1}
    batch = {"x": torch.randn(4, 128, 59, generator=gen, device="cuda"),
             "y": torch.randint(0, 8, (4, 128), generator=gen,
                                device="cuda")}
    full = model.step(params, batch, 0.01)

    def same(rows):
        part = model.step({k: v[rows] for k, v in params.items()},
                          {k: v[rows] for k, v in batch.items()}, 0.01)
        return all(torch.equal(part[k][0], full[k][0]) for k in full)
    return {"lone": same([0]), "two": same([0, 1]), "three": same([0, 1, 2]),
            "beside_a_copy": same([0, 0])}


def cards_rank(spec: dict, mesh) -> dict:
    """10 (e) on one NCCL rank of a world of one rank a card: phase 4b's
    sync runs (``sharded_classic``), phase 11 (a)'s async runs
    (``part2_async``) and the churn scenario, sync and async (its
    census kept), each through CUDA graphs that hold their gathers."""
    from repro_torch.launch.classic import classic_fixture
    t0 = time.perf_counter()
    out = {"classic": {arch: sharded_classic(arch, mesh, want)
                       for arch, want in spec["classic"].items()},
           "async": {}}
    for arch, init in spec["part2"]["init"].items():
        fx = classic_fixture(arch, samples=20000, n_edges=4, device="cuda")
        out["async"][arch] = part2_async(fx, init, mesh)
    out["scenario"] = churn_ranks(classic_fixture(
        "kmeans-traffic", samples=20000, n_edges=4, device="cuda"), mesh,
        contract=True)
    out["seconds"] = time.perf_counter() - t0
    out["ring"] = ring_decode(mesh)                        # 10 (f)
    return out


def rank_main(mode: str, spec_path: str) -> None:
    """One rank of phase 10's worlds (``chip_smoke.py --rank MODE SPEC``):
    ``gloo`` (2 ranks sharing the card), ``nccl`` (a world of one),
    ``cards`` and ``cards_lm`` (10 (e): NCCL, one rank a card)."""
    import pickle
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        fail("rank: no card")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import make_debug_mesh, make_mesh
    resolve_device("cuda")
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    if mode == "gloo":
        mesh = make_debug_mesh(RANKS, 1, device="cuda", backend="gloo")
        out = {"classic": {arch: sharded_classic(arch, mesh, want)
                           for arch, want in spec["classic"].items()},
               "lm": lm_rounds(spec["edge_batch"], spec["seq"], mesh)}
        t_axis = time.perf_counter()
        model_mesh = make_debug_mesh(1, RANKS, device="cuda",
                                     backend="gloo")
        out["model_axis"] = lm_model_axis(spec["edge_batch"], spec["seq"],
                                          model_mesh)
        out["model_axis"]["seconds"] = time.perf_counter() - t_axis
        out["part2"] = part2_rank(spec["part2"], mesh)     # phase 11
        out["ring"] = ring_decode(mesh)                    # 10 (f)
    elif mode == "nccl":
        mesh = make_mesh((1, 1), ("data", "model"))     # CUDA + NCCL
        arch = "svm-wafer"
        init = spec["classic"][arch]["init"]
        out = {"classic": {arch: sharded_classic(arch, mesh,
                                                 spec["classic"][arch])},
               "gather": captured_gather(mesh, {k: v.shape for k, v in
                                                init.items()}),
               "planned": planned_capture(
                   spec["classic"]["kmeans-traffic"]["init"]),
               "lanes": lane_rounding()}
    else:                               # one NCCL rank a card
        import os
        n = 2 if mode == "cards_lm" else int(os.environ["WORLD_SIZE"])
        mesh = make_debug_mesh(n, 1, device="cuda")
        if mode == "cards_lm":
            out = {"lm": lm_rounds(spec["edge_batch"], spec["seq"], mesh)}
        else:
            out = cards_rank(spec, mesh)
    out.update(rank=mesh.rank, backend=mesh.backend, mesh=dict(mesh.shape),
               modules=sorted(m for m in sys.modules if m.split(".")[0]
                              in ("jax", "jaxlib", "repro", "benchmarks")))
    with open(RANKS_DIR / f"{mode}{mesh.rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def rank_world(n: int, mode: str, spec: dict) -> list:
    import os
    import pickle
    from repro_torch.launch.hostdev import spawn_ranks
    RANKS_DIR.mkdir(parents=True, exist_ok=True)
    path = RANKS_DIR / f"{mode}_spec.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    t0 = time.perf_counter()
    procs = spawn_ranks(n, [sys.executable, str(ROOT / "chip_smoke.py"),
                            "--rank", mode, str(path)],
                        env=dict(os.environ, PYTHONPATH=str(SRC)),
                        capture=True, timeout=RANK_TIMEOUT)
    for r, p in enumerate(procs):
        check(p.returncode == 0, f"phase 10 {mode} rank {r} exited "
              f"{p.returncode}: {p.stderr[-3000:]}")
    out = []
    for r in range(n):
        with open(RANKS_DIR / f"{mode}{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    emit("ranks_world", mode=mode, ranks=n,
         seconds=time.perf_counter() - t0)
    return out


def lm_plans() -> dict:
    """The ``--step el_round`` plans of (b) (one edge a rank over 2 data
    ranks) and (d) (both edges, each model over 2 model ranks, its
    ``LM_AXIS_LAYERS`` window) at ``LM_EDGE_BATCH``: meta tensors on the host, run on a thread while the
    gloo world runs."""
    from repro_torch.launch import dryrun
    kw = dict(step_mode="el_round", h_max=LM_H_MAX,
              batch=LM_EDGE_BATCH * LM_EDGES, seq_len=LM_SEQ)
    return {"data": dryrun.plan_combo(LM_ARCH, "train_4k", edges_per_rank=1,
                                      data_ranks=RANKS, **kw),
            "model": dryrun.plan_combo(LM_ARCH, "train_4k",
                                       edges_per_rank=LM_EDGES,
                                       model_ranks=RANKS,
                                       layers=LM_AXIS_LAYERS, **kw)}


# -- phase 10 (f): the ring cache over ranks --------------------------------
# qwen3-1.7b at full width and depth, f32 (TF32 off), the long-context
# window (``LONG_CONTEXT_WINDOW``, 8192) kept as a ring (``ring_cache``),
# batch 1: a prefill of RING_PROMPT tokens (the ring wraps by 256; every
# layer's ``attention_fill_ring`` through the kernel's window branch, the
# f32 instance at FLASH_RING), then RING_DECODE greedy steps.  Once whole
# in this process (``attention_decode_ring``), then on each rank of 10's
# gloo world over its (2, 1) mesh, the filled ring cut to the rank's 4096
# slots (``make_decode_step(mesh=)``, ``CacheLayout.shard``;
# ``attention_decode_split(ring=True)``: the owner of slot ``index mod
# 8192`` writes it, every rank's partials are gathered and combined in rank
# order); on several cards 10 (e)'s NCCL ranks run it too, 2048 slots a rank
# of 4.  Each rank's logits within RING_TOL of the whole ring decode's at
# every step, its greedy tokens equal.
RING_ARCH = "qwen3-1.7b"
RING_PROMPT, RING_DECODE, RING_SEED = 8448, 16, 43
RING_TOL = 1e-4
FLASH_RING = (1, RING_PROMPT, 16, 8, 128, 8192, "float32")


def ring_decode(mesh=None) -> dict:
    """The ring decode above, whole (``mesh=None``) or as this rank's share
    of ``mesh``, every kernel count set to 0 just before the prefill and
    read after the last step: each step's f32 logits (on the host), the
    greedy tokens, the cache's layout and slots, seconds."""
    import gc
    import numpy as np
    import torch
    from repro_torch.config import get_config
    from repro_torch.launch.specs import LONG_CONTEXT_WINDOW
    from repro_torch.models import LM
    from repro_torch.train.state import make_decode_step
    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(RING_ARCH).model, dtype="float32",
                              sliding_window=LONG_CONTEXT_WINDOW)
    model = LM(cfg, device="cuda", ring_cache=True)
    params = model.init(torch.Generator(device="cuda").manual_seed(RING_SEED))
    prompt = torch.from_numpy(np.random.default_rng(RING_SEED).integers(
        0, cfg.vocab_size, (1, RING_PROMPT))).to("cuda")
    max_len = RING_PROMPT + RING_DECODE
    step = make_decode_step(model, mesh=mesh, batch=1, max_len=max_len)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = model.prefill(params, prompt,
                                      model.init_cache(1, max_len))
        tok = logits[:, -1:].argmax(-1)
        del logits
        ring = int(cache["groups"]["sub0"]["k"].shape[2])
        layout = "whole"
        if mesh is not None:
            params = step.layout.shard(params)
            cache = step.cache_layout.shard(cache)
            layout = ("sequence" if step.cache_layout.kv_split is not None
                      else "replicated")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        out_logits, tokens, step_ms = [], [], []
        for _ in range(RING_DECODE):
            t1 = time.perf_counter()
            lg, cache = step(params, tok, cache)
            tok = lg[:, -1:].argmax(-1)
            tokens.append(int(tok))
            step_ms.append((time.perf_counter() - t1) * 1e3)
            out_logits.append(lg[:, -1].float().cpu().numpy())
    launches = counts()
    out = {"logits": out_logits, "tokens": tokens, "layout": layout,
           "ring": ring, "slots": int(cache["groups"]["sub0"]["k"].shape[2]),
           "launches": launches, "prefill_s": prefill_s,
           "decode_ms": step_ms,
           "finite": all(bool(np.isfinite(x).all()) for x in out_logits),
           "seconds": time.perf_counter() - t0}
    del model, params, cache, step, lg
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ring_checks(ranks: list, ref: dict, card: str, where: str) -> int:
    """Each rank's ring decode (``res["ring"]``) against the whole one:
    the ring split over the world's edge ranks (its slots a rank), logits
    within RING_TOL at every step, tokens equal, the prefill's 28
    ``flash_attention`` launches; the lines.  Returns the ranks'
    launches."""
    import numpy as np
    n = len(ranks)
    launches = 0
    for r, res in enumerate(ranks):
        got = res["ring"]
        gap = max(float(np.abs(g - w).max()) for g, w in
                  zip(got["logits"], ref["logits"]))
        emit("ranks_ring_decode", where=where, rank=r, ranks=n, card=card,
             backend=res["backend"], mesh=res["mesh"], arch=RING_ARCH,
             dtype="float32", prompt=RING_PROMPT, steps=RING_DECODE,
             ring=got["ring"], slots_a_rank=got["slots"],
             layout=got["layout"], max_abs_logit_gap=gap, tol=RING_TOL,
             tokens=got["tokens"], tokens_equal=got["tokens"]
             == ref["tokens"], launches=got["launches"],
             prefill_s=got["prefill_s"],
             decode_ms_median=sorted(got["decode_ms"])[RING_DECODE // 2],
             whole_decode_ms_median=sorted(ref["decode_ms"])[
                 RING_DECODE // 2], seconds=got["seconds"])
        check(got["layout"] == "sequence" and got["ring"] == ref["ring"]
              and got["slots"] * n == ref["ring"],
              f"{where} rank {r}: the ring is not split over {n} ranks: "
              f"{got['layout']}, {got['slots']} of {got['ring']} slots")
        check(got["finite"] and gap <= RING_TOL,
              f"{where} rank {r}: logits {gap} from the whole ring decode's "
              f"(bound {RING_TOL})")
        check(got["tokens"] == ref["tokens"],
              f"{where} rank {r}: tokens {got['tokens']} vs "
              f"{ref['tokens']}")
        check(got["launches"]["flash_attention"] == ref["launches"][
            "flash_attention"] > 0, f"{where} rank {r}: flash_attention "
              f"launched {got['launches']}, the whole run {ref['launches']}")
        launches += got["launches"]["flash_attention"]
    return launches


def ring_reference() -> dict:
    """Phase 10 (f)'s whole ring decode on the card, and the kernel at its
    prefill's shape held to the plain version."""
    ref = ring_decode()
    emit("ring_decode_whole", arch=RING_ARCH, dtype="float32",
         prompt=RING_PROMPT, steps=RING_DECODE, ring=ref["ring"],
         tokens=ref["tokens"], launches=ref["launches"],
         prefill_s=ref["prefill_s"], decode_ms=ref["decode_ms"],
         card=card_line())
    check(ref["finite"] and ref["layout"] == "whole"
          and ref["ring"] < RING_PROMPT and ref["launches"][
              "flash_attention"] > 0,
          f"phase 10 (f): the whole ring decode: ring {ref['ring']}, "
          f"launches {ref['launches']}, finite {ref['finite']}")
    ref["kernel_err"] = flash_long_vs_plain(FLASH_RING)
    return ref


def sync_references() -> dict:
    """Phase 4b's unsharded sync runs of both fixtures on the card's
    generator, the second of two (the first captures): init, records,
    digest, seconds, launches, param bytes."""
    import torch
    from repro_torch.interop import params_to_numpy
    from repro_torch.kernels.kmeans_assign import ops as ka_ops
    from repro_torch.launch.classic import classic_fixture
    want = {}
    for arch in ("kmeans-traffic", "svm-wafer"):
        fx = classic_fixture(arch, samples=20000, n_edges=4, device="cuda")
        init = params_to_numpy(fx["init_params"])
        sess = compiled_session(fx, fx["init_params"])
        sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS)    # capture
        ka_ops.batched_launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS)
        torch.cuda.synchronize()
        want[arch] = {"init": init, "records": rank_records(rep),
                      "digest": tree_digest(rep.final_params),
                      "run_s": time.perf_counter() - t0,
                      "kmeans_assign_batched": ka_ops.batched_launches,
                      "param_bytes": sum(v.nbytes for v in init.values())}
        del sess, rep, fx
    return want


def async_references() -> dict:
    """Phase 4c's unsharded card runs on its replayed draws (numpy seed
    5) at K = 1 and the wave width, as phase 4c keeps them for phase 11:
    ``{arch: {"init", 1: {events, digest}, ASYNC_WAVE: ...}}``."""
    from repro_torch.interop import params_from_numpy, params_to_numpy
    from repro_torch.launch.classic import classic_fixture
    out = {}
    for arch in ("kmeans-traffic", "svm-wafer"):
        fx = classic_fixture(arch, samples=20000, n_edges=4, device="cuda")
        init = params_to_numpy(fx["init_params"])
        out[arch] = {"init": init}
        for bk in (1, ASYNC_WAVE):
            sess = async_session(fx, params_from_numpy(init, "cuda"), bk)
            rep = sess.run_async_ingraph(draws=async_replay_draws(
                sess.cfg, fx["executor"].batch, seed=5))
            out[arch][bk] = {"events": event_records(rep),
                             "digest": tree_digest(rep.final_params)}
    return out


def ranks_spec(want: dict, part2_refs: dict) -> dict:
    """What every rank of phase 10's worlds reads: the fixtures' inits and
    the LM round's sizes."""
    return {"classic": {a: {"init": w["init"]} for a, w in want.items()},
            "edge_batch": LM_EDGE_BATCH, "seq": LM_SEQ,
            "part2": {"init": {a: r["init"] for a, r in
                               part2_refs["async"].items()}}}


def cards_main() -> None:
    """``python3 chip_smoke.py --cards``: phase 10 (e) alone on a machine
    of 2 or more cards, after the build, with the unsharded card runs it
    is held to made here (phase 4b's sync runs, 4c's replayed async runs,
    the churn runs, 10 (b)'s one-rank round).  Exits 1 on one card."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    if torch.cuda.device_count() < 2:
        fail("--cards needs 2 or more cards, one NCCL rank a card")
    build_all()
    card = card_line()
    want = sync_references()
    refs = {"async": async_references()}
    base = part2_references(refs)
    one = lm_rounds(LM_EDGE_BATCH, LM_SEQ)
    ring_ref = ring_reference()
    out = cards_phase(ranks_spec(want, refs), want, refs, base, one, card,
                      ring_ref)
    print(card, flush=True)
    print(json.dumps({"ok": True, "cards": out["ranks"],
                      "seconds": out["seconds"]}), flush=True)


def ranks_phase(part2_refs: dict) -> dict:
    """Phases 10 and 11 in this process: the unsharded references (phase
    11's from phases 4c, 4d and 4f, ``part2_refs``, and the churn
    scenario's runs made here), the plan, the gloo world of 2 (which runs
    both phases), the NCCL world of 1 and, on several cards, 10 (e)'s
    worlds; each check, the lines."""
    import gc
    import torch
    card = card_line()
    t_phase = time.perf_counter()
    want = sync_references()
    edge_batch = LM_EDGE_BATCH
    one = lm_rounds(edge_batch, LM_SEQ)
    one_axis = lm_rounds(edge_batch, LM_SEQ, layers=LM_AXIS_LAYERS)
    t_base = time.perf_counter()
    base = part2_references(part2_refs)
    base_s = time.perf_counter() - t_base
    ring_ref = ring_reference()
    gc.collect()
    torch.cuda.empty_cache()
    spec = ranks_spec(want, part2_refs)
    # (b)'s and (d)'s plans on the host while the ranks run
    import threading
    from repro_torch.bench.roofline import CARD_MEMORY_BYTES
    plans: dict = {}
    planner = threading.Thread(target=lambda: plans.update(lm_plans()))
    planner.start()
    ranks = rank_world(RANKS, "gloo", spec)
    planner.join()
    check(set(plans) == {"data", "model"}, "phase 10: the plans failed")
    plan = plans["data"]
    check(RANKS * plan["memory"]["peak_live_bytes"]
          <= LM_CARD_SHARE * CARD_MEMORY_BYTES,
          f"phase 10: the planned per-rank peak at a per-edge batch of "
          f"{edge_batch}, {plan['memory']['peak_live_bytes']} bytes, does "
          f"not fit {LM_CARD_SHARE} of the card on {RANKS} ranks")
    nccl = rank_world(1, "nccl", spec)[0]
    out = {"kmeans_assign_batched": 0, "ssd_scan": one["ssd_scan"]}
    for arch, w in want.items():
        for r, res in enumerate(ranks):
            got = res["classic"][arch]
            n_edges = 4 // RANKS
            ag = got["collectives"].get("all-gather", {})
            emit("ranks_sharded_sync", arch=arch, rank=r, card=card,
                 backend=res["backend"], mesh=res["mesh"],
                 run_s=got["run_s"], rerun_s=got["rerun_s"],
                 unsharded_run_s=w["run_s"], gather_ms=got["gather_ms"],
                 rounds=len(got["records"]),
                 kmeans_assign_batched=got["kmeans_assign_batched"],
                 lanes=got["lanes"], collectives=got["collectives"],
                 collective_bytes=got["collective_bytes"],
                 device_loop=got["device_loop"])
            check(same_floats(got["records"], w["records"]) and
                  got["digest"] == w["digest"],
                  f"phase 10 {arch} rank {r}: the sharded run is not the "
                  "unsharded card run")
            check(got["rerun_same"], f"phase 10 {arch} rank {r}: a rerun "
                  "of the sharded program differs")
            check(got["device_loop"]["graphs_captured"] == 0,
                  f"phase 10 {arch} rank {r}: a sharded chunk was captured")
            check(ag.get("count", 0) >= 1 and
                  "all-reduce" not in got["collectives"],
                  f"phase 10 {arch} rank {r}: census {got['collectives']}")
            check(got["donated_same"] and got["donated_shares_storage"] and
                  got["donated_alias_bytes"] == w["param_bytes"] and
                  got["alias_bytes"] == 0,
                  f"phase 10 {arch} rank {r}: the donated run")
            if arch == "kmeans-traffic":
                check(got["kmeans_assign_batched"] > 0 and
                      got["lanes"] == [n_edges],
                      f"phase 10 kmeans rank {r}: launches "
                      f"{got['kmeans_assign_batched']}, lanes "
                      f"{got['lanes']}")
                out["kmeans_assign_batched"] += got["kmeans_assign_batched"]
    tol = PLAN_PEAK_TOL
    planned = plan["memory"]["peak_live_bytes"]
    for r, res in enumerate(ranks):
        lm = res["lm"]
        err = planned / lm["peak_bytes"] - 1.0
        emit("ranks_el_round", arch=LM_ARCH, rank=r, card=card,
             edges=lm["edges"], edge_batch=edge_batch, h_max=LM_H_MAX,
             intervals=LM_INTERVALS, round_s=lm["round_s"],
             gather_s=lm["gather_s"],
             one_rank_round_s=one["round_s"], losses=lm["losses"],
             ssd_scan=lm["ssd_scan"], peak_bytes=lm["peak_bytes"],
             planned_peak_bytes=planned, peak_error=err,
             plan_collectives=plan["collectives"],
             one_rank_peak_bytes=one["peak_bytes"])
        check(lm["digest"] == one["digest"] and lm["losses"] == one["losses"],
              f"phase 10 el_round rank {r}: the sharded round is not the "
              "one-rank round")
        check(lm["finite"] and all(x == x and abs(x) < float("inf")
                                   for x in lm["losses"]),
              f"phase 10 el_round rank {r}: non-finite")
        check(lm["ssd_scan"] > 0, f"phase 10 el_round rank {r}: ssd_scan "
              "never launched")
        check(abs(err) <= tol, f"phase 10 el_round rank {r}: planned peak "
              f"{planned} vs measured {lm['peak_bytes']} ({err:+.3f})")
        check(res["modules"] == [], f"rank {r} imported {res['modules']}")
        out["ssd_scan"] += lm["ssd_scan"]
    out["model_axis"] = model_axis_checks(ranks, one_axis, plans["model"],
                                         edge_batch, card)
    out["ring"] = {"kernel_err": ring_ref["kernel_err"],
                   "seconds": ring_ref["seconds"] + max(
                       res["ring"]["seconds"] for res in ranks),
                   "flash_attention": ring_ref["launches"]["flash_attention"]
                   + ring_checks(ranks, ring_ref, card, "phase 10 (f)")}
    got = nccl["classic"]["svm-wafer"]
    emit("ranks_nccl_world_of_one", card=card, backend=nccl["backend"],
         mesh=nccl["mesh"], collectives=got["collectives"],
         rounds=len(got["records"]), run_s=got["run_s"],
         device_loop=got["device_loop"])
    check(nccl["backend"] == "nccl" and got["collectives"] == {} and
          same_floats(got["records"], want["svm-wafer"]["records"]) and
          got["digest"] == want["svm-wafer"]["digest"],
          f"phase 10 NCCL world of one: {got['collectives']}")
    out["nccl_capture"] = nccl_capture_checks(nccl, card)
    out["kmeans_assign_batched"] += \
        out["nccl_capture"]["kmeans_assign_batched"]
    cards = torch.cuda.device_count()
    if cards >= 2:
        out["cards"] = cards_phase(spec, want, part2_refs, base, one, card,
                                   ring_ref)
        unverified = {}
    else:
        emit("ranks_cards", card=card, cards=cards, skipped="an NCCL world "
             "of several ranks needs several cards, one rank a card; this "
             "machine has one")
        unverified = {"unverified": "NCCL across several cards: this "
                      "machine has one card, so 10 (e) did not run; 10 (c) "
                      "captured an NCCL gather in a world of one"}
    out["part2"] = part2_checks(ranks, part2_refs, base, card)
    part2_s = base_s + max(res["part2"]["seconds"] for res in ranks)
    emit("ranks_part2", card=card, seconds=part2_s,
         unsharded_references_s=base_s,
         rank_seconds=[res["part2"]["seconds"] for res in ranks],
         **out["part2"],
         chunks={"gloo": "eager", "nccl": "captured"}, **unverified)
    out["seconds"] = time.perf_counter() - t_phase
    out["edge_batch"] = edge_batch
    emit("ranks", card=card, seconds=out["seconds"],
         phase_10_seconds=out["seconds"] - part2_s,
         model_axis_seconds=out["model_axis"]["seconds"],
         ring_seconds=out["ring"]["seconds"],
         flash_attention_ring=out["ring"]["flash_attention"],
         kmeans_assign_batched=out["kmeans_assign_batched"],
         ssd_scan=out["ssd_scan"],
         ssd_scan_model_axis=out["model_axis"]["ssd_scan"],
         edge_batch=edge_batch,
         chunks={"gloo": "eager", "nccl": "captured"},
         cards=out.get("cards", {}).get("ranks", 0), **unverified)
    return out


def nccl_capture_checks(nccl: dict, card: str) -> dict:
    """10 (c)'s two checks of the captured sharded chunk: (i) the graph
    holding the NCCL gather and the edge-order mean, bit-equal to the
    same ops run eagerly, its census the gather; (ii) the ``PlanMesh(2)``
    sync cell captured, bit-equal to the same cell eager, its launches
    the replays' count."""
    g, pl = nccl["gather"], nccl["planned"]
    emit("ranks_nccl_captured_gather", card=card, same=g["same"],
         replays=g["replays"], replay_ms=g["replay_ms"],
         collectives=g["collectives"],
         collective_bytes=g["collective_bytes"])
    check(g["same"], "phase 10 (c) (i): the captured NCCL gather and mean "
          "are not the same ops run eagerly")
    check(set(g["collectives"]) == {"all-gather"}
          and g["collectives"]["all-gather"]["count"] == 1
          and g["collective_bytes"] == g["stack_bytes"],
          f"phase 10 (c) (i): census {g['collectives']}")
    loop = pl["device_loop"]
    emit("ranks_planned_capture", arch="kmeans-traffic", card=card,
         mesh={"data": 2, "model": 1}, rounds=pl["rounds"],
         run_s=pl["run_s"], eager_s=pl["eager_s"],
         capture_loop=pl["capture_loop"], device_loop=loop,
         eager_loop=pl["eager_loop"],
         kmeans_assign_batched=pl["kmeans_assign_batched"])
    check(pl["same"], "phase 10 (c) (ii): the captured PlanMesh cell is not "
          "the same cell run eagerly")
    check(pl["sharded"] and pl["capturable"]
          and pl["capture_loop"]["graphs_captured"] == 1
          and loop["replays"] > 0 and loop["graphs_captured"] == 0
          and pl["eager_loop"]["graphs_captured"] == 0
          and pl["eager_loop"]["replays"] == 0,
          f"phase 10 (c) (ii): loops {pl['capture_loop']}, {loop}, "
          f"{pl['eager_loop']}")
    check(pl["kmeans_assign_batched"] == loop["replays"]
          * loop["kernel_launches_per_graph"] > 0,
          f"phase 10 (c) (ii): {pl['kmeans_assign_batched']} launches, "
          f"{loop}")
    lanes = nccl["lanes"]
    emit("ranks_lane_rounding", arch="svm-wafer", card=card,
         same_as_four_lanes=lanes)
    check(lanes["two"] and lanes["three"] and lanes["beside_a_copy"],
          f"phase 10 (c): the SVM step's lanes round apart {lanes}")
    return {"kmeans_assign_batched": pl["kmeans_assign_batched"]}


def cards_phase(spec: dict, want: dict, refs: dict, base: dict, one: dict,
                card: str, ring_ref: dict) -> dict:
    """10 (e): NCCL worlds of one rank a card (``min(4, cards)`` ranks,
    then 2 for the LM round), each rank's runs against the unsharded card
    runs made in this script (10 (f)'s ring decode against ``ring_ref``),
    the lines."""
    import torch
    n = min(4, torch.cuda.device_count())
    t0 = time.perf_counter()
    ranks = rank_world(n, "cards", spec)
    world_s = time.perf_counter() - t0
    lm_ranks = rank_world(2, "cards_lm", spec)
    out = {"ranks": n, "kmeans_assign_batched": 0, "ssd_scan": 0,
           "seconds": time.perf_counter() - t0}

    def loop_ok(got, where):
        loop = got["device_loop"]
        check(got["graphs_total"] >= 1 and loop["replays"] > 0,
              f"phase 10 (e) {where}: graphs {got['graphs_total']}, loop "
              f"{loop}")

    def census_ok(coll, where):
        check(coll.get("all-gather", {}).get("count", 0) >= 1
              and "all-reduce" not in coll,
              f"phase 10 (e) {where}: census {coll}")
    for r, res in enumerate(ranks):
        check(res["backend"] == "nccl" and res["modules"] == [],
              f"phase 10 (e) rank {r}: {res['backend']}, {res['modules']}")
        for arch, w in want.items():
            got = res["classic"][arch]
            emit("ranks_cards_sync", arch=arch, rank=r, ranks=n, card=card,
                 run_s=got["run_s"], rerun_s=got["rerun_s"],
                 unsharded_run_s=w["run_s"], gather_ms=got["gather_ms"],
                 graphs=got["graphs_total"], device_loop=got["device_loop"],
                 collectives=got["collectives"],
                 kmeans_assign_batched=got["kmeans_assign_batched"],
                 lanes=got["lanes"])
            check(same_floats(got["records"], w["records"])
                  and got["digest"] == w["digest"] and got["rerun_same"],
                  f"phase 10 (e) {arch} rank {r}: not the unsharded run")
            loop_ok(got, f"{arch} rank {r}")
            census_ok(got["collectives"], f"{arch} rank {r}")
            check(got["donated_same"] and got["donated_shares_storage"]
                  and got["donated_alias_bytes"] == w["param_bytes"],
                  f"phase 10 (e) {arch} rank {r}: the donated run")
            out["kmeans_assign_batched"] += got["kmeans_assign_batched"]
        for arch, runs in res["async"].items():
            ref = refs["async"][arch]
            got = runs["auto"]
            bk = got["device_loop"]["batch_k"]
            emit("ranks_cards_async", arch=arch, rank=r, ranks=n, card=card,
                 batch_k=bk, run_s=got["run_s"], rerun_s=got["rerun_s"],
                 unsharded_run_s=base["async_s"][arch, bk],
                 gather_ms=got["gather_ms"], graphs=got["graphs_total"],
                 device_loop=got["device_loop"],
                 collectives=got["collectives"],
                 kmeans_assign_batched=got["kmeans_assign_batched"],
                 lanes=got["lanes"])
            check(bk == ASYNC_WAVE and same_floats(got["events"],
                                                   ref[1]["events"])
                  and got["digest"] == ref[bk]["digest"]
                  and got["rerun_same"] and runs["donated"]["same"],
                  f"phase 10 (e) async {arch} rank {r}: not the unsharded "
                  f"K = {bk} run")
            loop_ok(got, f"async {arch} rank {r}")
            census_ok(got["collectives"], f"async {arch} rank {r}")
            out["kmeans_assign_batched"] += got["kmeans_assign_batched"]
        for mode, got in res["scenario"].items():
            w = base["scenario"][mode]
            emit("ranks_cards_scenario", arch="kmeans-traffic", mode=mode,
                 churn=CHURN, rank=r, ranks=n, card=card, run_s=got["run_s"],
                 rerun_s=got["rerun_s"], unsharded_run_s=w["run_s"],
                 graphs=got["graphs_total"], device_loop=got["device_loop"],
                 collectives=got["collectives"],
                 kmeans_assign_batched=got["kmeans_assign_batched"])
            check(got["digest"] == {k: w[k] for k in
                                    ("raw", "params", "rounds")}
                  and got["rerun_same"],
                  f"phase 10 (e) churn {mode} rank {r}: not the unsharded "
                  "run")
            loop_ok(got, f"churn {mode} rank {r}")
            census_ok(got["collectives"], f"churn {mode} rank {r}")
            out["kmeans_assign_batched"] += got["kmeans_assign_batched"]
    out["flash_attention"] = ring_checks(ranks, ring_ref, card,
                                         "phase 10 (e) ring")
    for r, res in enumerate(lm_ranks):
        lm = res["lm"]
        emit("ranks_cards_el_round", arch=LM_ARCH, rank=r, card=card,
             edges=lm["edges"], round_s=lm["round_s"],
             gather_s=lm["gather_s"], one_rank_round_s=one["round_s"],
             losses=lm["losses"], ssd_scan=lm["ssd_scan"])
        check(res["backend"] == "nccl" and lm["digest"] == one["digest"]
              and lm["losses"] == one["losses"] and lm["finite"]
              and lm["ssd_scan"] > 0,
              f"phase 10 (e) el_round rank {r}: not the one-rank round")
        out["ssd_scan"] += lm["ssd_scan"]
    emit("ranks_cards", card=card, ranks=n, seconds=out["seconds"],
         world_seconds=world_s,
         rank_seconds=[res["seconds"] for res in ranks],
         kmeans_assign_batched=out["kmeans_assign_batched"],
         ssd_scan=out["ssd_scan"], flash_attention=out["flash_attention"],
         chunks="captured")
    return out


def model_axis_checks(ranks: list, one: dict, plan: dict, edge_batch: int,
                      card: str) -> dict:
    """(d)'s lines and checks: each rank's blocks against the one-rank
    state at (d)'s layer window after its first round (``one``), its loss,
    ``ssd_scan``, its peak against the plan."""
    planned = plan["memory"]["peak_live_bytes"]
    launches = 0
    for r, res in enumerate(ranks):
        ma = res["model_axis"]
        err = planned / ma["peak_bytes"] - 1.0
        emit("ranks_el_round_model_axis", arch=LM_ARCH, rank=r, card=card,
             layers=LM_AXIS_LAYERS, mesh={"data": 1, "model": RANKS},
             edges=ma["edges"],
             edge_batch=edge_batch, h_max=LM_H_MAX,
             intervals=LM_INTERVALS[0], round_s=ma["round_s"],
             one_rank_first_round_s=one["round_s"][0],
             gather_pass_s=ma["gather_pass_s"], seconds=ma["seconds"],
             losses=ma["losses"], ssd_scan=ma["ssd_scan"],
             split_leaves=ma["split"], peak_bytes=ma["peak_bytes"],
             planned_peak_bytes=planned, peak_error=err,
             plan_collectives=plan["collectives"],
             plan_s=plan["plan_s"])
        check(ma["digest"] == one["first_blocks"][r],
              f"phase 10 (d) rank {r}: the model-axis round's blocks are "
              "not the one-rank state's after its first round")
        check(ma["losses"] == one["losses"][:1],
              f"phase 10 (d) rank {r}: loss {ma['losses']} vs "
              f"{one['losses'][:1]}")
        check(ma["finite"] and all(x == x and abs(x) < float("inf")
                                   for x in ma["losses"]),
              f"phase 10 (d) rank {r}: non-finite")
        check(ma["split"] > 0, f"phase 10 (d) rank {r}: no leaf is split")
        check(ma["ssd_scan"] > 0, f"phase 10 (d) rank {r}: ssd_scan never "
              "launched")
        check(abs(err) <= PLAN_PEAK_TOL,
              f"phase 10 (d) rank {r}: planned peak {planned} vs measured "
              f"{ma['peak_bytes']} ({err:+.3f})")
        launches += ma["ssd_scan"]
    return {"ssd_scan": launches,
            "seconds": max(res["model_axis"]["seconds"] for res in ranks)}


# -- phase 11: several ranks, part 2 -------------------------------------------

# In phase 10's world of 2 gloo ranks on the one card, after phase 10's
# runs: (a) phase 4c's full-width fixtures on its replayed draws through
# ``run_async_ingraph(mesh=)`` at K = 1 and at the width the mesh resolves
# (4), against phase 4c's unsharded card runs, then donated; (b) phase
# 4d's grids through ``sweep(mesh=)`` against its unsharded sweeps; (c)
# phase 4f's kmeans-traffic async cohort through ``FleetServer(mesh=)``
# against its reports; (d) a churn scenario (the reference's mesh test's:
# rate 0.3, period 16) sync and async on kmeans-traffic against the
# unsharded card runs made here.  Each rank's run reads every kernel count
# from 0 and each batched ``kmeans_assign`` launch's lane count.
CHURN = (0.3, 16)
GATHER_REPS = 50


class LaunchCounts:
    """Every kernel's launch count set to 0 on entry and read on exit,
    and the lanes of each batched ``kmeans_assign`` launch (a captured
    graph's at its capture)."""

    def __enter__(self):
        from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
        self.lanes, self._orig = [], ka_kernel.assign_fwd_batched

        def counted(x, *rest):
            self.lanes.append(int(x.shape[0]))
            return self._orig(x, *rest)
        ka_kernel.assign_fwd_batched = counted
        reset_counts()
        return self

    def __exit__(self, *exc):
        import torch
        from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
        torch.cuda.synchronize()
        per_width: dict = {}
        for w in self.lanes:
            per_width[w] = per_width.get(w, 0) + 1
        self.row = dict(counts(), lanes=sorted(per_width),
                        launches_by_lanes=per_width)
        ka_kernel.assign_fwd_batched = self._orig
        return False


def timed(fn):
    """``(fn(), seconds)``, the card synchronized before the clock
    stops."""
    import torch
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def churn_session(fx, init, mode):
    from repro_torch.el import ELSession
    from repro_torch.el.scenarios import ChurnSpec, ScenarioSpec
    cfg = dataclasses.replace(
        fx["exp"].ol4el, mode=mode, n_edges=4, utility=fx["utility"],
        scenario=ScenarioSpec(churn=ChurnSpec(rate=CHURN[0],
                                              period=CHURN[1])))
    return (ELSession(cfg, metric_name=fx["metric"], lr=fx["lr"])
            .with_executor(fx["executor"], init_params=init,
                           n_samples=fx["n_samples"]))


def churn_run(sess, mode, mesh=None, **kw):
    """The scenario's run on the card's own generator (``cfg.seed +
    17``), over ``mesh``."""
    if mode == "sync":
        return sess.run_sync_ingraph(max_rounds=COMPILED_ROUNDS, mesh=mesh,
                                     **kw)
    return sess.run_async_ingraph(mesh=mesh, **kw)


def churn_ranks(fx, mesh, contract: bool = False) -> dict:
    """The churn scenario, sync and async, over ``mesh`` on one rank: the
    counted run (``contract``: armed, its census kept), then a rerun."""
    out = {}
    for mode in ("sync", "async"):
        sess = churn_session(fx, fx["init_params"], mode)
        kw = {"contract": True} if contract else {}
        with LaunchCounts() as lc:
            rep, secs = timed(lambda: churn_run(sess, mode, mesh, **kw))
        again, rerun_s = timed(lambda: churn_run(sess, mode, mesh))
        out[mode] = {
            "digest": churn_digest(rep), "rerun_same":
            churn_digest(again) == churn_digest(rep), "run_s": secs,
            "rerun_s": rerun_s, "device_loop": rep.telemetry["device_loop"],
            "graphs_total": sess._fastpath.graphs_captured, **lc.row}
        if contract:
            out[mode]["collectives"] = rep.telemetry["profile"]["collectives"]
    return out


def churn_digest(rep) -> dict:
    return {"raw": out_digest(rep.raw), "params": tree_digest(
        rep.final_params), "rounds": rep.n_aggregations}


def gather_ms(params, group, lanes: int) -> float:
    """One all-gather of ``lanes`` rows of ``params`` over ``group``, ms
    (mean of ``GATHER_REPS``, after one untimed)."""
    import torch
    from repro_torch.launch.mesh import gather_edge_stack
    stack = {k: v.unsqueeze(0).expand(lanes, *v.shape).contiguous()
             for k, v in params.items()}
    gather_edge_stack(stack, group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GATHER_REPS):
        gather_edge_stack(stack, group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / GATHER_REPS * 1e3


def part2_async(fx, init, mesh) -> dict:
    """(a) on one rank: the run at K = 1 and at the mesh's width (the
    counted run with the contract armed, then a rerun of the profiled
    program), the gather alone, then the mesh-width run donated."""
    from repro_torch.interop import params_from_numpy

    def go(sess, **kw):
        return sess.run_async_ingraph(draws=async_replay_draws(
            sess.cfg, fx["executor"].batch, seed=5), mesh=mesh, **kw)
    out = {}
    for name, bk in (("one", 1), ("auto", 0)):
        sess = async_session(fx, params_from_numpy(init, "cuda"), bk)
        with LaunchCounts() as lc:
            rep, secs = timed(lambda: go(sess, contract=True))
        again, rerun_s = timed(lambda: go(sess))
        prof = rep.telemetry["profile"]
        out[name] = {
            "events": event_records(rep),
            "digest": tree_digest(rep.final_params), "run_s": secs,
            "rerun_s": rerun_s, "rerun_same": same_floats(
                event_records(again), event_records(rep))
            and tree_digest(again.final_params) == tree_digest(
                rep.final_params),
            "collectives": prof["collectives"],
            "collective_bytes": prof["collective_bytes"],
            "alias_bytes": prof["alias_bytes"],
            "device_loop": rep.telemetry["device_loop"], **lc.row,
            "graphs_total": sess._fastpath.graphs_captured,
            "gather_ms": gather_ms(rep.final_params, mesh.edge_group(),
                                   rep.telemetry["device_loop"]["batch_k"])}
    donated = params_from_numpy(init, "cuda")
    drep = go(async_session(fx, donated, 0), donate=True, contract=True)
    out["donated"] = {
        "same": same_floats(event_records(drep), out["auto"]["events"])
        and tree_digest(drep.final_params) == out["auto"]["digest"],
        "alias_bytes": drep.telemetry["profile"]["alias_bytes"],
        "shares_storage": all(drep.final_params[k].data_ptr()
                              == donated[k].data_ptr() for k in donated)}
    return out


def part2_rank(spec: dict, mesh) -> dict:
    """Phase 11 on one rank of phase 10's gloo world."""
    from repro_torch.el.fleet import ReportReady, RoundDelta
    from repro_torch.launch.classic import classic_fixture
    t_part = time.perf_counter()
    fixtures = {arch: {"cuda": classic_fixture(arch, samples=20000,
                                               n_edges=4, device="cuda")}
                for arch in ("kmeans-traffic", "svm-wafer")}
    out = {"async": {arch: part2_async(fixtures[arch]["cuda"], init, mesh)
                     for arch, init in spec["init"].items()},
           "sweep": {}, "scenario": {}}
    # (b) phase 4d's grids: the counted run captures each sub-grid's graph,
    # the rerun replays it
    for arch in fixtures:
        for mode in ("sync", "async"):
            sess = sweep_session(fixtures[arch]["cuda"], mode)
            grid = sweep_grid(sess, mode)
            with LaunchCounts() as lc:
                rep, secs = timed(lambda: sess.sweep(grid, mesh=mesh))
            again, rerun_s = timed(lambda: sess.sweep(grid, mesh=mesh))
            out["sweep"][arch, mode] = {
                "digest": sweep_digest(rep), "rerun_same":
                sweep_digest(again) == sweep_digest(rep), "run_s": secs,
                "rerun_s": rerun_s, "cells": rep.n_cells,
                "loops": rep.telemetry["device_loops"], **lc.row}
    # (c) phase 4f's kmeans async cohort, 2 of its 4 slots a rank
    cfgs = {("kmeans-traffic", "async"):
            fleet_runs(fixtures)["kmeans-traffic", "async"]}
    from repro_torch.el.cache import ProgramCache
    server, events = fleet_server(fixtures, cfgs, ProgramCache(2), mesh)
    with LaunchCounts() as lc:
        reports, secs = timed(server.drain)
    cohort = server.cohorts()[0]
    out["fleet"] = {
        "reports": {tid: fleet_digest(r) for tid, r in reports.items()},
        "stream_ok": all(
            isinstance(evs[-1], ReportReady)
            and all(isinstance(e, RoundDelta) for e in evs[:-1])
            and same_floats([dataclasses.astuple(e.record)
                             for e in evs[:-1]], _records(reports[tid]))
            for tid, evs in events.items()),
        "stats": server.stats(), "run_s": secs,
        "slots": ([0, cohort.batch.n_slots] if cohort.batch.shard is None
                  else [cohort.batch.shard.lo, cohort.batch.shard.hi]),
        "graphs_captured": cohort.batch.program.graphs_captured, **lc.row}
    server.close()
    # (d) the churn scenario, sync and async
    out["scenario"] = churn_ranks(fixtures["kmeans-traffic"]["cuda"], mesh)
    out["seconds"] = time.perf_counter() - t_part
    return out


def part2_references(refs: dict) -> dict:
    """Phase 11's unsharded side on the card: phase 4c's replayed runs
    again (their seconds, the graph reused; their events checked against
    4c's), and the churn scenario's runs (digests and seconds)."""
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.classic import classic_fixture
    out = {"async_s": {}, "scenario": {}}
    for arch, want in refs["async"].items():
        fx = classic_fixture(arch, samples=20000, n_edges=4, device="cuda")
        for bk in (1, ASYNC_WAVE):
            sess = async_session(fx, params_from_numpy(want["init"], "cuda"),
                                 bk)

            def go():
                return sess.run_async_ingraph(draws=async_replay_draws(
                    sess.cfg, fx["executor"].batch, seed=5))
            go()                                # capture
            rep, secs = timed(go)
            check(same_floats(event_records(rep), want[bk]["events"])
                  and tree_digest(rep.final_params) == want[bk]["digest"],
                  f"phase 11 {arch} batch_k={bk}: the unsharded rerun is "
                  "not phase 4c's run")
            out["async_s"][arch, bk] = secs
        if arch == "kmeans-traffic":
            for mode in ("sync", "async"):
                sess = churn_session(fx, fx["init_params"], mode)
                first = churn_run(sess, mode)
                rep, secs = timed(lambda: churn_run(sess, mode))
                check(churn_digest(rep) == churn_digest(first),
                      f"phase 11 churn {mode}: the unsharded rerun differs")
                out["scenario"][mode] = dict(churn_digest(rep), run_s=secs)
        del fx
    return out


def part2_checks(ranks: list, refs: dict, base: dict, card: str) -> dict:
    """Phase 11's checks and lines over every rank's results; returns the
    single ``kmeans_assign`` launches of the ranks' runs and the batched
    ones in two parts: the eager runs' (the async engine's and the churn
    scenario's sharded chunks, every launch seen, so counted by lane
    count) and the graph runs' (a rank's sweep cells and cohort slots,
    the cells row's; their lane counts as captured)."""
    n = {"kmeans_assign_batched": 0, "kmeans_assign": 0,
         "launches_by_lanes": {}, "kmeans_assign_batched_cells": 0,
         "cells_lanes": []}

    def tally(row, where, graphs=False):
        check(row["ssd_scan"] == 0 and row["flash_attention"] == 0,
              f"phase 11 {where}: unexpected kernel launches {row}")
        n["kmeans_assign"] += row["kmeans_assign"]
        if graphs:
            n["kmeans_assign_batched_cells"] += row["kmeans_assign_batched"]
            n["cells_lanes"] = sorted(set(n["cells_lanes"])
                                      | set(row["lanes"]))
            return
        check(sum(row["launches_by_lanes"].values())
              == row["kmeans_assign_batched"],
              f"phase 11 {where}: batched launches {row} not all seen")
        n["kmeans_assign_batched"] += row["kmeans_assign_batched"]
        by = n["launches_by_lanes"]
        for w, c in row["launches_by_lanes"].items():
            by[w] = by.get(w, 0) + c

    for r, res in enumerate(ranks):
        p2 = res["part2"]
        for arch, runs in p2["async"].items():
            want = refs["async"][arch]
            for name, got in ((n_, runs[n_]) for n_ in ("one", "auto")):
                bk = got["device_loop"]["batch_k"]
                ag = got["collectives"].get("all-gather", {})
                edge_bytes = sum(v.nbytes for v in want["init"].values())
                emit("ranks_sharded_async", arch=arch, rank=r, width=name,
                     batch_k=bk, card=card, run_s=got["run_s"],
                     rerun_s=got["rerun_s"],
                     unsharded_run_s=base["async_s"][arch, bk],
                     gather_ms=got["gather_ms"],
                     events=len(got["events"]),
                     kmeans_assign_batched=got["kmeans_assign_batched"],
                     lanes=got["lanes"], collectives=got["collectives"],
                     gathered_bytes_per_step=ag.get("bytes", 0) / 16,
                     predicted_bytes_per_step=bk * edge_bytes,
                     device_loop=got["device_loop"])
                check(bk == (1 if name == "one" else ASYNC_WAVE),
                      f"phase 11 {arch} rank {r}: K {bk} for {name}")
                check(same_floats(got["events"], want[1]["events"]),
                      f"phase 11 {arch} rank {r} K={bk}: the events are not "
                      "phase 4c's unsharded K = 1 card run's")
                check(got["digest"] == want[bk]["digest"],
                      f"phase 11 {arch} rank {r} K={bk}: the final params "
                      f"are not phase 4c's unsharded K = {bk} card run's")
                check(got["rerun_same"], f"phase 11 {arch} rank {r}: a "
                      "rerun differs")
                check(got["device_loop"]["graphs_captured"] == 0,
                      f"phase 11 {arch} rank {r}: a sharded chunk was "
                      "captured")
                check(ag.get("count", 0) == 16 and "all-reduce" not in
                      got["collectives"] and ag["bytes"] == 16 * bk
                      * edge_bytes,
                      f"phase 11 {arch} rank {r}: census "
                      f"{got['collectives']}")
                if arch == "kmeans-traffic":
                    check(got["kmeans_assign_batched"] > 0
                          and got["lanes"] == [bk],
                          f"phase 11 kmeans rank {r}: launches "
                          f"{got['kmeans_assign_batched']}, lanes "
                          f"{got['lanes']}")
                tally(got, f"{arch} {name}")
            d = runs["donated"]
            check(d["same"] and d["shares_storage"] and d["alias_bytes"]
                  == sum(v.nbytes for v in want["init"].values())
                  and runs["auto"]["alias_bytes"] == 0,
                  f"phase 11 {arch} rank {r}: the donated run {d}")
        for (arch, mode), got in p2["sweep"].items():
            want = refs["sweep"][arch, mode]
            emit("ranks_sharded_sweep", arch=arch, mode=mode, rank=r,
                 card=card, cells=got["cells"], run_s=got["run_s"],
                 rerun_s=got["rerun_s"], unsharded_run_s=want["run_s"],
                 loops=got["loops"],
                 kmeans_assign_batched=got["kmeans_assign_batched"],
                 lanes=got["lanes"])
            check(got["digest"] == {k: want[k] for k in ("out", "params")}
                  and got["rerun_same"],
                  f"phase 11 sweep {arch} {mode} rank {r}: the cells are "
                  "not phase 4d's")
            check([lp["n_cells"] for lp in got["loops"]] == (
                [SWEEP_CELLS // 2] if mode == "sync" else [4, 4]),
                f"phase 11 sweep {arch} {mode} rank {r}: cells a rank "
                f"{got['loops']}")
            tally(got, f"sweep {arch} {mode}", graphs=True)
        got = p2["fleet"]
        emit("ranks_sharded_fleet", arch="kmeans-traffic", mode="async",
             rank=r, card=card, slots=got["slots"], drain_s=got["run_s"],
             unsharded_cohort_waves_s=refs["fleet_waves_s"],
             stats=got["stats"], graphs_captured=got["graphs_captured"],
             kmeans_assign_batched=got["kmeans_assign_batched"],
             lanes=got["lanes"])
        check(got["reports"] == refs["fleet"] and got["stream_ok"],
              f"phase 11 fleet rank {r}: the reports are not phase 4f's")
        check(got["slots"] == [2 * r, 2 * r + 2] and
              got["stats"]["tenants_done"] == FLEET_TENANTS,
              f"phase 11 fleet rank {r}: slots {got['slots']}")
        tally(got, "fleet", graphs=True)
        for mode, got in p2["scenario"].items():
            want = base["scenario"][mode]
            emit("ranks_sharded_scenario", arch="kmeans-traffic", mode=mode,
                 churn=CHURN, rank=r, card=card, run_s=got["run_s"],
                 rerun_s=got["rerun_s"], unsharded_run_s=want["run_s"],
                 rounds=got["digest"]["rounds"],
                 device_loop=got["device_loop"],
                 kmeans_assign_batched=got["kmeans_assign_batched"],
                 lanes=got["lanes"])
            check(got["digest"] == {k: want[k] for k in
                                    ("raw", "params", "rounds")}
                  and got["rerun_same"],
                  f"phase 11 churn {mode} rank {r}: not the unsharded run")
            tally(got, f"churn {mode}")
    return n


# -- phase 8: times and bounds ------------------------------------------------

def kmeans_timing(n: int, d: int, k: int) -> dict:
    import torch
    from repro_torch.kernels.kmeans_assign import kernel, ops, ref
    from repro_torch.bench.roofline import F32_FLOPS, HBM_BW
    x, c = km_inputs(n, d, k, "float32", seed=7)
    flops, nbytes = ops.work(n, d, k)
    t_bytes, t_ops = nbytes / HBM_BW, flops / F32_FLOPS
    out = {"n": n, "d": d, "k": k,
           "centres_a_tile": kernel.plan(d, k, kernel.max_smem(0))[1]}
    for key, fn in (("", lambda: ops.assign_with_dist(x, c)),
                    ("plain_", lambda: ref.assign_ref(x, c)),
                    ("library_", lambda: torch.cdist(x, c).min(-1))):
        out[key + "ms"] = cuda_ms(fn, queued=True)       # the card's time
        out[key + "call_ms"] = cuda_ms(fn)               # host enqueue incl.
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def kmeans_batched_timing(e: int, n: int, d: int, k: int) -> dict:
    """The batched entry at the compiled round's local-step shape beside
    ``e`` launches of the single entry on the same inputs, the plain
    version and the library's batched ``cdist`` + ``min``."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    from repro_torch.bench.roofline import F32_FLOPS, HBM_BW
    x, c = km_batched_inputs(e, n, d, k, "float32", seed=8)
    flops, nbytes = ops.work(n, d, k, e)
    t_bytes, t_ops = nbytes / HBM_BW, flops / F32_FLOPS
    out = {"e": e, "n": n, "d": d, "k": k}
    for key, fn in (
            ("", lambda: ops.assign_with_dist_batched(x, c)),
            ("singles_", lambda: [ops.assign_with_dist(x[i], c[i])
                                  for i in range(e)]),
            ("plain_", lambda: ref.assign_ref(x, c)),
            ("library_", lambda: torch.cdist(x, c).min(-1))):
        out[key + "ms"] = cuda_ms(fn, queued=True)       # the card's time
        out[key + "call_ms"] = cuda_ms(fn)               # host enqueue incl.
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def kmeans_cells_timing(n_cells: int, e: int, n: int, d: int,
                        k: int) -> dict:
    """The batched entry at a sweep's local-step shape, all C·E (cell,
    edge) pairs in one launch, beside the plain version and the library's
    batched ``cdist`` + ``min``; ``vmap_call_ms`` is the call as the
    sweep makes it, through ``torch.func.vmap`` and the op's fold rule
    (host enqueue included)."""
    import torch
    from repro_torch.kernels.kmeans_assign import ops, ref
    pairs = n_cells * e
    x, c = km_batched_inputs(pairs, n, d, k, "float32", seed=9)
    xv, cv = x.view(n_cells, e, n, d), c.view(n_cells, e, k, d)
    from repro_torch.bench.roofline import F32_FLOPS, HBM_BW
    vmapped = torch.func.vmap(ops.assign_with_dist_batched)
    flops, nbytes = ops.work(n, d, k, pairs)
    t_bytes, t_ops = nbytes / HBM_BW, flops / F32_FLOPS
    out = {"cells": n_cells, "e": e, "pairs": pairs, "n": n, "d": d,
           "k": k}
    for key, fn in (
            ("", lambda: ops.assign_with_dist_batched(x, c)),
            ("plain_", lambda: ref.assign_ref(x, c)),
            ("library_", lambda: torch.cdist(x, c).min(-1))):
        out[key + "ms"] = cuda_ms(fn, queued=True)       # the card's time
        out[key + "call_ms"] = cuda_ms(fn)               # host enqueue incl.
    out["vmap_call_ms"] = cuda_ms(lambda: vmapped(xv, cv))
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    return out


def ssd_timing(b, s, h, p, n, chunk, dtype_name) -> dict:
    """The kernel's card time at one shape beside its plain version's and
    its bound (bf16 operations at the tensor cores' rate, f32 at the CUDA
    cores', as each instance runs).  No single PyTorch call computes the
    SSD scan, so there is no library time."""
    import torch
    from repro_torch.bench.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS
    from repro_torch.kernels.ssd_scan import kernel, ops, ref
    x, da, bm, cm = ssd_inputs(b, s, h, p, n, dtype_name, seed=11)
    # each input read once, each output written once; the operations on
    # the causal triangle of the L x L terms only (``ops.work``)
    flops, nbytes = ops.work(b, s, h, p, n, chunk, x.element_size())
    peak = PEAK_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    run = kernel.plan(b, s, h, p, n, chunk, x.dtype, kernel.max_smem(0),
                      kernel.sm_count(0))
    out = {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
           "dtype": dtype_name, "p_tile": run.p_tile, "plan": run._asdict()}
    for key, fn, iters in (
            ("", lambda: ops.ssd(x, da, bm, cm, chunk), 50),
            ("plain_", lambda: ref.ssd_reference(x, da, bm, cm, chunk), 20)):
        out[key + "ms"] = cuda_ms(fn, iters=iters, warmup=5, queued=True)
        out[key + "call_ms"] = cuda_ms(fn, iters=iters, warmup=5)
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops, library_ms=None)
    return out


def sdpa_name(gqa: bool, window: int = 0) -> str:
    mask = (f"attn_mask=<[S, S] bool causal band of {window}>"
            if window else "is_causal=True")
    return ("torch.nn.functional.scaled_dot_product_attention("
            f"{mask}, enable_gqa={gqa})")


def flash_timing(b, s, h, kv, d, window, dtype_name) -> dict:
    """The kernel's card time at one shape beside its plain version's, the
    library's (SDPA; timed here as a yardstick, never called by the port)
    and its bound (bf16 operations at the tensor cores' rate, f32 at the
    CUDA cores', as each instance runs)."""
    import torch
    from repro_torch.bench.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS
    from repro_torch.kernels.flash_attention import kernel, ops, ref
    q, k, v = flash_inputs(b, s, h, kv, d, dtype_name, seed=13)
    # q, k, v read once, o written once; QK^T and PV on the attended
    # pairs (the causal triangle, cut to the window; ``ops.work``)
    pairs = ops.attended_pairs(s, window)
    flops, nbytes = ops.work(b, s, h, kv, d, window, q.element_size())
    peak = PEAK_FLOPS if q.dtype == torch.bfloat16 else F32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # [B, H, S, D]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = kv != h                 # MHA shapes call SDPA without the flag
    if window:
        pos = torch.arange(s, device="cuda")
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[None, :] > pos[:, None] - window)

        def library():
            return sdpa(qt, kt, vt, attn_mask=band, enable_gqa=gqa)
    else:
        def library():
            return sdpa(qt, kt, vt, is_causal=True, enable_gqa=gqa)
    out = {"b": b, "s": s, "h": h, "kv": kv, "d": d, "window": window,
           "instance_d": kernel.padded_head_dim(d), "dtype": dtype_name,
           "library": sdpa_name(gqa, window), "pairs_per_sequence": pairs}
    # the long instances' plain version holds tens of GB of logits: fewer
    # repeats
    few = 20 if s <= 4096 else 3
    for key, fn, iters in (
            ("", lambda: ops.flash_attention(q, k, v, window=window),
             50 if s <= 4096 else 10),
            ("plain_", lambda: ref.attention_ref(q, k, v, window=window),
             few),
            ("library_", library, 50 if s <= 4096 else 10)):
        warm = 5 if s <= 4096 else 1
        out[key + "ms"] = cuda_ms(fn, iters=iters, warmup=warm, queued=True)
        out[key + "call_ms"] = cuda_ms(fn, iters=iters, warmup=warm)
    out.update(bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    if out["instance_d"] != d:
        # what the pad costs: the same call at the instance's head dim
        wide = flash_inputs(b, s, h, kv, out["instance_d"], dtype_name,
                            seed=14)
        out["instance_ms"] = cuda_ms(lambda: ops.flash_attention(
            *wide, window=window), iters=50, warmup=5, queued=True)
        del wide
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return out


def sass_census(library: Path, kernel: str, params) -> dict:
    """Tensor-core instructions in each instance of a kernel's SASS
    (``cuobjdump -sass`` on the built library): HMMA is ``mma.sync``,
    HGMMA ``wgmma``.  Functions are named ``<kernel>_<instance>`` with int
    template arguments named by ``params`` (a tuple, or a dict of tuples by
    instance), keyed as ``instance<param=value,...>``."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    census, name = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            m = re.search(rf"{kernel}_(\w+?)(?:I((?:Li\d+E)+)E|E|$)", line)
            name = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                names = (params.get(m.group(1), ()) if isinstance(
                    params, dict) else params)
                name = m.group(1) + (
                    "<" + ",".join(f"{p}={a}" for p, a in zip(names, args))
                    + ">" if args else "")
                census[name] = {"HMMA": 0, "HGMMA": 0}
        elif name:
            op = re.search(r"\b(HGMMA|HMMA)\.", line)
            if op:
                census[name][op.group(1)] += 1
    return census


def count_f32_launches() -> None:
    """Wrap both kernels' launch functions (``kernel.flash_fwd``,
    ``kernel.ssd_fwd``, which every op call that launches goes through) so
    that each launch of an f32 instance is counted (``F32_PENDING``)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    for mod, fn, name in ((fa_kernel, "flash_fwd", "flash_attention"),
                          (ssd_kernel, "ssd_fwd", "ssd_scan")):
        def counted(x, *args, _launch=getattr(mod, fn), _name=name):
            if x.dtype.itemsize == 4:
                F32_PENDING[_name] += 1
            return _launch(x, *args)
        setattr(mod, fn, counted)


def f32_entries(log: str) -> dict:
    """Each f32 entry of an nvcc ``-Xptxas -v`` log (a function whose name
    holds ``_f32``): its registers and spill bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"kernel_(f32\w*?)(?:I(Li\d+E)E|E)", m.group(1))
            name = None
            if k:
                name = k.group(1) + (
                    "<" + k.group(2)[2:-1] + ">" if k.group(2) else "")
                out[name] = {}
        elif name and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            name = None
    return out


def build_all() -> None:
    """Compile every kernel's source at once (one nvcc each), then load."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.kmeans_assign import kernel as ka_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    kernels = {"kmeans_assign": ka_kernel, "ssd_scan": ssd_kernel,
               "flash_attention": fa_kernel}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
        paths = dict(zip(kernels, pool.map(lambda k: k.library_path(),
                                           kernels.values())))
    seconds = time.perf_counter() - t0
    census = sass_census(paths["flash_attention"], "flash_attention_kernel",
                         ("D",))
    ssd_census = sass_census(paths["ssd_scan"], "ssd_scan_kernel",
                             {"bf16": ("Pt", "items"), "f32_carry": ("NV",)})
    # ptxas reports static shared memory only; these two use dynamic
    extra = {"ssd_scan": {
        "dynamic_smem_bytes_at_P64_N128_L128": {
            "float32": ssd_kernel.smem_bytes(64, 128, 128, torch.float32),
            "bfloat16": {f"Pt={t}": ssd_kernel.smem_bytes(
                64, 128, 128, torch.bfloat16, t) for t in (32, 64)}},
        "dynamic_smem_limit": ssd_kernel.max_smem(0),
        "sass_tensor_core_instructions": ssd_census},
        "flash_attention": {
        "dynamic_smem_bytes": {
            str(dt).removeprefix("torch."): {
                f"D={d}": fa_kernel.smem_bytes(d, dt)
                for d in fa_kernel.HEAD_DIMS}
            for dt in (torch.bfloat16, torch.float32)},
        "dynamic_smem_limit": fa_kernel.max_smem(0),
        "sass_tensor_core_instructions": census}}
    f32 = {}
    for name, mod in kernels.items():
        mod.library()
        log_path = paths[name].with_suffix(".log")
        log = log_path.read_text() if log_path.exists() else ""
        if name != "kmeans_assign":
            # the f32 (CUDA-core) entries: registers and spills
            f32[name] = extra[name]["f32_ptxas"] = f32_entries(log)
        emit("build", kernel=name, seconds=seconds,
             library=str(paths[name].relative_to(ROOT)),
             ptxas=[ln.strip() for ln in log.splitlines()
                    if ("ptxas info" in ln or "spill" in ln)
                    and "Compile time" not in ln],
             **extra.get(name, {}))
    for d in fa_kernel.HEAD_DIMS:
        counts = census.get(f"bf16<D={d}>", {})
        check(counts.get("HMMA", 0) + counts.get("HGMMA", 0) > 0,
              f"flash_attention bf16 at D={d}: no tensor-core instruction "
              f"in its SASS: {census}")
    bf16 = {k: v for k, v in ssd_census.items() if k.startswith("bf16<")}
    check(len(bf16) == 3 * len(ssd_kernel.P_TILES)
          and all(v["HMMA"] > 0 for v in bf16.values()),
          f"ssd_scan: a bf16 instance without HMMA in its SASS: "
          f"{ssd_census}")
    # f32 stays on the CUDA cores (no TF32): no tensor-core instruction,
    # and no spills
    for name, c in (("flash_attention", census), ("ssd_scan", ssd_census)):
        entries = {k: v for k, v in c.items() if k.startswith("f32")}
        check(len(entries) == len(f32[name]) > 0
              and all(v["HMMA"] + v["HGMMA"] == 0 for v in entries.values()),
              f"{name}: an f32 instance with tensor-core instructions, or "
              f"not one found: {c}, {f32[name]}")
        check(all(v.get("spill_stores", 1) + v.get("spill_loads", 1) == 0
                  for v in f32[name].values()),
              f"{name}: an f32 entry spills: {f32[name]}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    resolve_device("cuda")                    # also turns TF32 off
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         tf32=torch.backends.cuda.matmul.allow_tf32)

    build_all()
    count_f32_launches()
    km_err, km_errs = kernel_vs_plain()
    kmb_errs = kernel_batched_vs_plain()
    kmb_err = kmb_errs[KM_BATCHED_MAIN]
    kmc_err = max(kernel_cells_vs_plain(SWEEP_CELLS),
                  kernel_cells_vs_plain(FLEET_SLOTS))
    ssd_errs = ssd_vs_plain()
    ssd_err = ssd_errs[SSD_MAIN]
    fa_errs = flash_vs_plain()
    fa_err = fa_errs[FLASH_MAIN]
    launches, host_s = slice_phase()
    fixtures = classic_fixtures()
    compiled = compiled_phase(host_s, fixtures)
    events = async_phase(fixtures)
    sweep = sweep_phase(fixtures)
    scenarios = scenario_phase(fixtures)
    fleet = fleet_phase(fixtures)
    telemetry = telemetry_phase(fixtures)
    del fixtures
    figures = figures_phase()
    bench = bench_phase()
    launches["kmeans_assign"] += events["kmeans_assign"] + \
        sweep["kmeans_assign"] + scenarios["kmeans_assign"] + \
        fleet["kmeans_assign"] + telemetry["kmeans_assign"] + \
        figures["kmeans_assign"] + bench["kmeans_assign"]
    launches["kmeans_assign_batched"] = (compiled["kmeans_assign_batched"]
                                         + events["kmeans_assign_batched"]
                                         + scenarios["kmeans_assign_batched"]
                                         + telemetry["kmeans_assign_batched"])
    launches.update(serve_phase())
    served = serve_attention_phase()
    launches.update(train_phase())
    train_vs_plain()
    minicpm = minicpm_train_phase()
    train_vs_plain("minicpm-2b", MINICPM_BATCH, MINICPM_SEQ,
                   phase="train_minicpm_vs_plain")
    moe_served = serve_moe_phase()
    deepseek_served = serve_deepseek_phase()
    mamba_trained = mamba_train_phase()
    train_vs_plain("mamba2-370m", phase="train_mamba_vs_plain",
                   kernel="ssd_scan", f32_tol=MAMBA_F32_TOL)
    musicgen = musicgen_train_phase()
    train_vs_plain("musicgen-medium", phase="train_musicgen_vs_plain",
                   f32_tol=MULTIMODAL_F32_TOL)
    paligemma = paligemma_train_phase()
    train_vs_plain("paligemma-3b", PALIGEMMA_BATCH,
                   phase="train_paligemma_vs_plain",
                   f32_tol=MULTIMODAL_F32_TOL)
    musicgen_served = serve_musicgen_phase()
    paligemma_served = serve_paligemma_phase()
    jamba_served = serve_jamba_phase()
    long_served = serve_long_context_phase()
    hybrid_trained = train_hybrid_phase()
    ol4el_phase()
    planner_phase(moe_served, deepseek_served, minicpm, jamba_served,
                  hybrid_trained)
    mesh_planned = mesh_plan_phase()
    fa_errs[FLASH_MESH_TRAIN] = mesh_planned["errs"][FLASH_MESH_TRAIN]
    ssd_errs[SSD_MESH_PREFILL] = mesh_planned["errs"][SSD_MESH_PREFILL]
    examples = examples_phase()
    ranks = ranks_phase({"async": events["replayed"],
                         "sweep": sweep["digests"],
                         "fleet": fleet["kmeans_async"],
                         "fleet_waves_s": fleet["kmeans_async_waves_s"]})
    launches["kmeans_assign"] += ranks["part2"]["kmeans_assign"]
    fa_errs[FLASH_RING] = ranks["ring"]["kernel_err"]
    # each f32 (CUDA-core) instance's launches on this run's paths, by the
    # phase line each came before (phase 3's are its kernel-vs-plain
    # checks); phase 10 (f)'s ring prefill on its gloo ranks apart
    emit("f32_launches",
         flash_attention=dict(F32_BY_PHASE["flash_attention"]),
         ssd_scan=dict(F32_BY_PHASE["ssd_scan"]),
         flash_attention_ring_prefill_whole_and_ranks=ranks["ring"][
             "flash_attention"])

    km_shapes = [kmeans_timing(*s) for s in MAIN_SHAPES + [MICRO_SHAPE]]
    km = km_shapes[0]
    emit("kmeans_timing", case="microbench E-step", **km_shapes[-1])
    km_tiled = dict(kmeans_timing(*KM_TILED), max_abs_err=km_errs[KM_TILED])
    emit("kmeans_timing", case="a 1,024-entry codebook in centre tiles",
         **km_tiled)
    km_shapes.append(km_tiled)
    kmb = kmeans_batched_timing(*KM_BATCHED_MAIN)
    emit("kmeans_batched_timing", **kmb)
    kms = kmeans_batched_timing(*KM_BATCHED_SHARDED)
    emit("kmeans_batched_timing", case="phase 10: a rank's share", **kms)
    # phase 11's batched launches at each lane count they ran at (the
    # eager runs': a rank's event lane, async wave, churn round share; the
    # graph runs': a rank's cohort slots and sweep cells), each shape
    # timed and held against the plain version
    p2 = ranks["part2"]

    def lane_timing(w, **kw):
        shape = (w,) + KM_BATCHED_MAIN[1:]
        if shape not in kmb_errs:
            kmb_errs[shape] = batched_case_vs_plain(*shape, "float32",
                                                    seed=70 + w)
        t = dict(kmeans_batched_timing(*shape), **kw,
                 max_abs_err=kmb_errs[shape])
        emit("kmeans_batched_timing", case=f"phase 11: {w} lanes a launch",
             **t)
        return t
    p2_shapes = [lane_timing(w, launches=c) for w, c in
                 sorted(p2["launches_by_lanes"].items())]
    kmp2 = max(p2_shapes, key=lambda t: t["launches"])
    p2_cell_shapes = [lane_timing(w, path="a rank's sweep cells or cohort "
                                  "slots") for w in p2["cells_lanes"]]
    kmc = kmeans_cells_timing(SWEEP_CELLS, *KM_BATCHED_MAIN)
    emit("kmeans_cells_timing", **kmc)
    kmf = kmeans_cells_timing(FLEET_SLOTS, *KM_BATCHED_MAIN)  # the fleet's
    emit("kmeans_cells_timing", **kmf)
    ssd = ssd_timing(*SSD_MAIN)
    emit("ssd_timing", **ssd)
    ssd32 = ssd_timing(*SSD_MAIN[:-1], "float32")
    emit("ssd_timing", **ssd32)
    ssd_admit = ssd_timing(1, 128, *SSD_MAIN[2:])    # a lone admitted prompt
    emit("ssd_timing", **ssd_admit)
    ssd_train = ssd_timing(*SSD_TRAIN)
    emit("ssd_timing", case="mamba2-370m training", **ssd_train)
    ssd_c256 = dict(ssd_timing(*SSD_CHUNK256),
                    max_abs_err=ssd_errs[SSD_CHUNK256])
    emit("ssd_timing", case="chunk 256 in sub-chunks of 128", **ssd_c256)
    fa = flash_timing(*FLASH_MAIN)
    emit("flash_timing", **fa)
    fa32 = flash_timing(*FLASH_MAIN[:-1], "float32")
    emit("flash_timing", **fa32)
    fa_5m = flash_timing(*FLASH_5M)
    emit("flash_timing", case="train_lm_ol4el --preset 5m: D = 48 on the "
         "D = 64 instance", **fa_5m)
    fa_d96 = dict(flash_timing(*FLASH_D96), max_abs_err=fa_errs[FLASH_D96])
    emit("flash_timing", case="bf16 D = 96 on the D = 128 instance",
         **fa_d96)
    fa_serve = flash_timing(*FLASH_SERVE)
    emit("flash_timing", case="qwen3-1.7b serving prefill", **fa_serve)
    fa_minicpm = flash_timing(*FLASH_MINICPM)
    emit("flash_timing", case="minicpm-2b training", **fa_minicpm)
    fa_moe = flash_timing(*FLASH_MOE)
    emit("flash_timing", case="olmoe-1b-7b / deepseek-moe-16b serving "
         "prefill", **fa_moe)
    fa_musicgen = flash_timing(*FLASH_MUSICGEN)
    emit("flash_timing", case="musicgen-medium training", **fa_musicgen)
    fa_musicgen_serve = flash_timing(*FLASH_MUSICGEN_SERVE)
    emit("flash_timing", case="musicgen-medium serving prefill",
         **fa_musicgen_serve)
    fa_paligemma = flash_timing(*FLASH_PALIGEMMA)
    emit("flash_timing", case="paligemma-3b training and prefix prefill",
         **fa_paligemma)
    fa_paligemma_serve = flash_timing(*FLASH_PALIGEMMA_SERVE)
    emit("flash_timing", case="paligemma-3b engine prefill",
         **fa_paligemma_serve)
    fa_jamba = flash_timing(*FLASH_JAMBA)
    emit("flash_timing", case="jamba-1.5 serving prefill", **fa_jamba)
    fa_jamba_train = flash_timing(*FLASH_JAMBA_TRAIN)
    emit("flash_timing", case="jamba-1.5 interleave training",
         **fa_jamba_train)
    fa_long = flash_timing(*FLASH_LONG)
    emit("flash_timing", case="qwen3-1.7b long-context prefill, window "
         f"{FLASH_LONG[5]}", **fa_long)
    ssd_jamba = ssd_timing(*SSD_JAMBA)
    emit("ssd_timing", case="jamba-1.5 serving prefill", **ssd_jamba)
    ssd_jamba32 = ssd_timing(*SSD_JAMBA[:-1], "float32")
    emit("ssd_timing", case="jamba-1.5 kernel-vs-naive fill at f32",
         **ssd_jamba32)
    ssd_jamba_train = ssd_timing(*SSD_JAMBA_TRAIN)
    emit("ssd_timing", case="jamba-1.5 interleave training",
         **ssd_jamba_train)
    fa_mesh = flash_timing(*FLASH_MESH_TRAIN)
    emit("flash_timing", case="phase 9c: rank 0's share of qwen3-1.7b "
         "train_4k on the 2x16x16 mesh", **fa_mesh)
    fa_ring = flash_timing(*FLASH_RING)
    emit("flash_timing", case="phase 10 (f): qwen3-1.7b's f32 ring-cache "
         f"prefill, window {FLASH_RING[5]}", **fa_ring)
    ssd_mesh = ssd_timing(*SSD_MESH_PREFILL)
    emit("ssd_timing", case="phase 9c: rank 0's share of mamba2-370m "
         "prefill_32k on the 16x16 mesh", **ssd_mesh)
    ssd_el = (ranks["edge_batch"],) + SSD_TRAIN[1:]
    ssd_el_round = ssd_timing(*ssd_el)
    emit("ssd_timing", case="phase 10: the OL4EL round, one edge's batch",
         **ssd_el_round)
    instance_keys = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
                     "bound_by")

    def instances(bf16, f32):
        return {"bfloat16": {"cores": "tensor (mma.sync)",
                             **{k: bf16[k] for k in instance_keys}},
                "float32": {"cores": "CUDA (f32 FMA)",
                            **{k: f32[k] for k in instance_keys}}}
    # an empty kernel queued the same way: what a launch alone costs
    launch_floor_ms = cuda_ms(lambda: torch.cuda._sleep(0), queued=True)
    print(json.dumps({"kernels": [{
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20",
        "launches": launches["kmeans_assign"], "max_abs_err": km_err,
        "ms": km["ms"], "kernel_ms": km["ms"], "call_ms": km["call_ms"],
        "plain_ms": km["plain_ms"], "bound_ms": km["bound_ms"],
        "bound_by": km["bound_by"], "library_ms": km["library_ms"],
        "launch_floor_ms": launch_floor_ms, "shapes": km_shapes}, {
        "name": "kmeans_assign_batched", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20 (under "
                    "jax.vmap, src/repro/el/ingraph.py:526)",
        "launches": launches["kmeans_assign_batched"],
        "max_abs_err": kmb_err, "ms": kmb["ms"], "kernel_ms": kmb["ms"],
        "call_ms": kmb["call_ms"], "plain_ms": kmb["plain_ms"],
        "bound_ms": kmb["bound_ms"], "bound_by": kmb["bound_by"],
        "library_ms": kmb["library_ms"],
        "library": "torch.cdist(x, c).min(-1) on [E, N, D] x [E, K, D]",
        "singles_ms": kmb["singles_ms"],
        "singles_call_ms": kmb["singles_call_ms"],
        "launch_floor_ms": launch_floor_ms, "shapes": [kmb]}, {
        "name": "kmeans_assign_batched_sharded", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20 (under "
                    "jax.vmap over a shard's edges, src/repro/el/"
                    "ingraph.py:526, sharded by :338-379)",
        "path": "phase 10: run_sync_ingraph(mesh=) on 2 gloo ranks, each "
                "rank's 2 of 4 edges a launch, chunks eager (a); and 10 (c) "
                "(ii): the same cell over a PlanMesh(2) on the NCCL rank, "
                "rank 0's 2 of 4 edges, in CUDA graph replays (replays x "
                "launches a graph); cards_launches: 10 (e)'s captured "
                "runs over NCCL ranks, one a card, where the machine has "
                "several",
        "launches": ranks["kmeans_assign_batched"],
        "cards_launches": ranks.get("cards", {}).get(
            "kmeans_assign_batched"),
        "max_abs_err": kmb_errs[KM_BATCHED_SHARDED], "ms": kms["ms"],
        "kernel_ms": kms["ms"], "call_ms": kms["call_ms"],
        "plain_ms": kms["plain_ms"], "bound_ms": kms["bound_ms"],
        "bound_by": kms["bound_by"], "library_ms": kms["library_ms"],
        "library": "torch.cdist(x, c).min(-1) on [E, N, D] x [E, K, D]",
        "launch_floor_ms": launch_floor_ms, "shapes": [kms]}, {
        "name": "kmeans_assign_batched_sharded_async", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20 (under "
                    "jax.vmap over a wave's lanes, src/repro/el/events/"
                    "program.py:363-373, sharded by :79-88)",
        "path": "phase 11 on 2 gloo ranks, eager chunks: "
                "run_async_ingraph(mesh=) (every rank's wave of 4 lanes, the "
                "2 it owns live, or one event's lane) and the churn "
                "scenario's sync round and event body; the headline numbers "
                "are those of the lane count with the most launches, and "
                "every lane count run is timed and counted under shapes",
        "launches": ranks["part2"]["kmeans_assign_batched"],
        "max_abs_err": max(t["max_abs_err"] for t in p2_shapes),
        "ms": kmp2["ms"], "kernel_ms": kmp2["ms"],
        "call_ms": kmp2["call_ms"], "plain_ms": kmp2["plain_ms"],
        "bound_ms": kmp2["bound_ms"], "bound_by": kmp2["bound_by"],
        "library_ms": kmp2["library_ms"],
        "library": "torch.cdist(x, c).min(-1) on [E, N, D] x [E, K, D]",
        "launch_floor_ms": launch_floor_ms, "shapes": p2_shapes}, {
        "name": "kmeans_assign_batched_cells", "route": "cuda",
        "source": "src/repro_torch/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign/kernel.py:20 (under "
                    "jax.vmap over edges, src/repro/el/ingraph.py:526, and "
                    "over cells, src/repro/el/sweep/engine.py:190, and so "
                    "over a fleet cohort's slots)",
        "path": "phases 4d-4h's grids and cohorts, and phase 11's sweep "
                "cells and cohort slots over 2 gloo ranks (each rank's "
                "lane counts timed under shapes)",
        "launches": sweep["kmeans_assign_batched"]
        + scenarios["kmeans_assign_batched_cells"]
        + fleet["kmeans_assign_batched_cells"]
        + telemetry["kmeans_assign_batched_cells"]
        + p2["kmeans_assign_batched_cells"],
        "max_abs_err": max([kmc_err] + [t["max_abs_err"]
                                        for t in p2_cell_shapes]), "ms": kmc["ms"], "kernel_ms": kmc["ms"],
        "call_ms": kmc["call_ms"], "vmap_call_ms": kmc["vmap_call_ms"],
        "plain_ms": kmc["plain_ms"], "bound_ms": kmc["bound_ms"],
        "bound_by": kmc["bound_by"], "library_ms": kmc["library_ms"],
        "library": "torch.cdist(x, c).min(-1) on [C*E, N, D] x [C*E, K, D]",
        "launch_floor_ms": launch_floor_ms,
        "shapes": [kmc, kmf] + p2_cell_shapes}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:32",
        "launches": launches["ssd_scan"], "max_abs_err": ssd_err,
        "ms": ssd["ms"], "kernel_ms": ssd["ms"], "call_ms": ssd["call_ms"],
        "plain_ms": ssd["plain_ms"], "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"], "library_ms": None,
        "instances": instances(ssd, ssd32),
        "launch_floor_ms": launch_floor_ms,
        "shapes": [ssd, ssd32, ssd_admit, ssd_c256]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "launches": launches["flash_attention"], "max_abs_err": fa_err,
        "ms": fa["ms"], "kernel_ms": fa["ms"], "call_ms": fa["call_ms"],
        "plain_ms": fa["plain_ms"], "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"], "library_ms": fa["library_ms"],
        "library": fa["library"],
        "instances": instances(fa, fa32),
        "launch_floor_ms": launch_floor_ms, "shapes": [fa, fa32, fa_d96]}] + [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:30",
        "path": path, "launches": n, "max_abs_err": fa_errs[case],
        "ms": t["ms"], "kernel_ms": t["ms"], "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "library": t["library"],
        "launch_floor_ms": launch_floor_ms, "shapes": [t]}
        for name, path, n, case, t in (
            ("flash_attention_5m_train",
             "phase 9b: train_lm_ol4el --preset 5m --rounds 10 (4 edges, "
             "B = 4, S = 256, 4 heads of 48 at f32: q, k and v zero-padded "
             "to the D = 64 instance), every layer's forward",
             examples["train_lm_ol4el_5m"]["launches"]["flash_attention"],
             FLASH_5M, fa_5m),
            ("flash_attention_serve_prefill",
             "phase 5b: qwen3-1.7b serving, every layer's prefill fill",
             served["flash_attention"], FLASH_SERVE, fa_serve),
            ("flash_attention_minicpm_train",
             "phase 6b: minicpm-2b training, every layer's forward and "
             "remat recompute (D = 64, MHA)",
             minicpm["flash_attention"], FLASH_MINICPM, fa_minicpm),
            ("flash_attention_moe_serve_prefill",
             "phases 5c and 5d: olmoe-1b-7b and deepseek-moe-16b serving, "
             "every layer's prefill fill (16 heads of 128, MHA)",
             moe_served["flash_attention"]
             + deepseek_served["flash_attention"], FLASH_MOE, fa_moe),
            ("flash_attention_musicgen_train",
             "phase 6d: musicgen-medium training, every layer's forward and "
             "remat recompute (24 heads of 64, MHA)",
             musicgen["flash_attention"], FLASH_MUSICGEN, fa_musicgen),
            ("flash_attention_musicgen_serve_prefill",
             "phase 5e: musicgen-medium serving, every layer's prefill fill "
             "([4, S] prompts)",
             musicgen_served["flash_attention"], FLASH_MUSICGEN_SERVE,
             fa_musicgen_serve),
            ("flash_attention_paligemma_train",
             "phases 6e and 5f: paligemma-3b training (every layer's forward "
             "and remat recompute) and the prefill of 256 prefix embeddings "
             "before 512 tokens (8 query heads of 256, 1 KV head, D = 256)",
             paligemma["flash_attention"]
             + paligemma_served["prefix_flash_attention"], FLASH_PALIGEMMA,
             fa_paligemma),
            ("flash_attention_paligemma_serve_prefill",
             "phase 5f: paligemma-3b's engine prefill of text prompts, every "
             "layer's fill (D = 256, MQA)",
             paligemma_served["flash_attention"], FLASH_PALIGEMMA_SERVE,
             fa_paligemma_serve),
            ("flash_attention_jamba_serve_prefill",
             "phase 5g: jamba-1.5-large-398b serving at full width, layers "
             "2-4, the attention layer's prefill fill (64 query heads over "
             "8 KV heads of 128)",
             jamba_served["flash_attention"], FLASH_JAMBA, fa_jamba),
            ("flash_attention_jamba_train",
             "phase 6f: jamba-1.5's (MAMBA, DENSE), (ATTN, DENSE) trained "
             "at full width, the attention layer's forward and remat "
             "recompute",
             hybrid_trained["flash_attention"], FLASH_JAMBA_TRAIN,
             fa_jamba_train),
            ("flash_attention_long_context_prefill",
             "phase 5h: qwen3-1.7b with a sliding window of 8192, the "
             "prefill of 2 x 12,288 tokens (attention_fill and "
             "attention_fill_ring: the kernel's window branch)",
             long_served["flash_attention"], FLASH_LONG, fa_long),
            ("flash_attention_mesh_train",
             "phase 9c: rank 0's share of qwen3-1.7b train_4k on the "
             "2x16x16 mesh (its 8 rows, each layer's weights gathered over "
             "a PlanMesh), a clean step's forward and remat recompute",
             mesh_planned["flash_attention"], FLASH_MESH_TRAIN,
             fa_mesh),
            ("flash_attention_ring_prefill",
             "phase 10 (f): qwen3-1.7b at f32 with a ring cache of 8192 "
             "slots, the prefill of 8,448 tokens (attention_fill_ring: the "
             "f32 instance's window branch), whole and on each of 2 gloo "
             "ranks (on several cards also 10 (e)'s NCCL ranks) before "
             "the filled ring is split over the ranks for the decode",
             ranks["ring"]["flash_attention"]
             + ranks.get("cards", {}).get("flash_attention", 0), FLASH_RING,
             fa_ring))] + [{
        "name": "ssd_scan_mamba_train", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:32",
        "path": "phase 6c: mamba2-370m training, every layer's forward and "
                "remat recompute (the backward through the plain "
                "ssd_reference)",
        "launches": mamba_trained["ssd_scan"],
        "max_abs_err": ssd_errs[SSD_TRAIN], "ms": ssd_train["ms"],
        "kernel_ms": ssd_train["ms"], "call_ms": ssd_train["call_ms"],
        "plain_ms": ssd_train["plain_ms"], "bound_ms": ssd_train["bound_ms"],
        "bound_by": ssd_train["bound_by"], "library_ms": None,
        "launch_floor_ms": launch_floor_ms, "shapes": [ssd_train]}] + [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:32",
        "path": path, "launches": n, "max_abs_err": ssd_errs[case],
        "ms": t["ms"], "kernel_ms": t["ms"], "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "launch_floor_ms": launch_floor_ms, "shapes": shapes}
        for name, path, n, case, t, shapes in (
            ("ssd_scan_jamba_serve_prefill",
             "phase 5g: jamba-1.5-large-398b serving at full width, layers "
             "2-4, both Mamba layers' prefill (128 heads of P = N = 128, P "
             "tile 64; the f32 instance in the kernel-vs-naive fill, "
             "uncounted)",
             jamba_served["ssd_scan"], SSD_JAMBA, ssd_jamba,
             [ssd_jamba, ssd_jamba32]),
            ("ssd_scan_jamba_train",
             "phase 6f: jamba-1.5's (MAMBA, DENSE), (ATTN, DENSE) trained "
             "at full width, the Mamba layer's forward and remat recompute",
             hybrid_trained["ssd_scan"], SSD_JAMBA_TRAIN, ssd_jamba_train,
             [ssd_jamba_train]),
            ("ssd_scan_el_round",
             "phase 10: local_sgd.make_el_round on mamba2-370m at full "
             "width, one rank with both edges and 2 gloo ranks with one "
             "each, every layer's forward and remat recompute",
             ranks["ssd_scan"], ssd_el, ssd_el_round, [ssd_el_round]),
            ("ssd_scan_el_round_model_axis",
             "phase 10 (d): local_sgd.make_el_round on mamba2-370m at full "
             "width over a (1 data x 2 model) mesh of 2 gloo ranks, both "
             "edges on each rank, each edge's model split over the ranks "
             "(its layers' weights gathered before use), every layer's "
             "forward and remat recompute on each rank",
             ranks["model_axis"]["ssd_scan"], ssd_el, ssd_el_round,
             [ssd_el_round]),
            ("ssd_scan_mesh_prefill",
             "phase 9c: rank 0's share of mamba2-370m prefill_32k on the "
             "16x16 mesh (its 2 rows of 32,768 tokens), 3 clean prefills",
             mesh_planned["ssd_scan"], SSD_MESH_PREFILL, ssd_mesh,
             [ssd_mesh]))]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--cards"]:
        cards_main()
    else:
        main()
