#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --out results/chip_smoke.json   # also a JSON
    python3 chip_smoke.py --phases serve_sharded,shard_timings

``--phases`` runs only the named phases (the keys of the ``[phases]
seconds`` line, ``PHASES``), ``build``, and the earlier phases whose
results a named one reads (``PHASE_NEEDS``; the script names each one it
adds); without it every phase runs.  The last line is the same either
way.

Phases, in order; the first failure stops the script with a non-zero exit
and no result line:

1. Device: require CUDA; print the card's name and power limit.
2. Build the three CUDA sources from ``src/repro_torch/kernels/csrc``
   (nvcc, one process each, all started together; the cost library holds
   two kernels) and print the build seconds.
3. Cost kernel vs its plain version on the card (rtol 1e-5, atol 1e-2):
   every paper workload x 3 dataflows x the 12 x 12 level grid, random raw
   points at (4096, 53), ragged shapes (1, 1), (3, 7), (13, 130); each
   case also with the kernel reading its operands broadcast ((144, 1)
   columns and a dataflow by value) or strided (a column slice and
   transposed arrays) against the plain version on the dense inputs;
   and the engines' shapes on mobilenet_v2: each layer row at (4, 1)
   with df by value (an a2c / ppo2 rollout step of E = 4) and the whole
   table at (1, 53) (a relaxed hard probe).
   Then the per-row cost kernel vs its plain version (rtol 1e-5, atol
   1e-2): the six paper workloads as ragged rows padded with repeat = 0
   rows x 3 dataflows x random level points, random raw points at
   (1, 3392), (1, 5300) and (1, 27136) (an NSGA-II generation of 64, a
   GA generation of 100 and a random-search batch of 512 on
   mobilenet_v2), the mix3 co-design workload's ragged rows (30 points of
   ``multi_dnn`` over qwen1.5-0.5b, whisper-small and mamba2-130m),
   ragged (1, 1), (3, 7), (13, 130);
   padding rows exactly 0, and rows of one workload bit-equal to the
   single-table kernel.  Every case is also read in place from one
   packed (M, 11) row block (the service's upload, stride 11), through
   the wrapper and through ``ops.batched_cost_multi`` as (M, 4) rows and
   as four planes; the padded rows as (B, N) views of one block with pe
   a number; and each workload's (N, 8) table broadcast over 20 rows
   with a (B, 1) kt column and df a number, against the table kernel:
   each form bit-equal to the contiguous call.
4. LSTM kernels vs their plain versions (atol 1e-5) at ``LSTM_SHAPES``:
   the forward's h', c' and the gates it saves for the backward, the
   backward from those gates, on its single pass and forced onto its
   tiled kernel (each against the plain version in its signature and
   against the one that recomputes the gates; a second call must give
   the same bits), and the autograd Function against autograd through
   the plain version.
5. Flash-decode kernel vs its plain version (atol 1e-4 in float32 and in
   bfloat16: both read the same values and compute in float32), at the
   LM path's shape (8, 16, 2, 128, T = 520), a 32k cache, the reference's
   test shapes, ragged T, head dims 16 / 64 / 256, G up to 16, the split
   plan's edges (a split of one key, one tile + 1 key, T just over a
   whole number of splits, B * Hkv large enough for one split), the
   reference's decode_32k batch and length (128, 16, 2, 128, 32768), the
   other families' shapes of phase 8b (whisper's and llama-3.2-vision's
   cross-attention, qwen3-MoE's self-attention at G = 16, zamba2's shared
   block), and views ``cache[:, :L]`` of a longer cache.  A second call on
   the same inputs must give the same bits, and the combine kernel must
   launch exactly when the plan has more than one split.
6. Main path: ``api.run_search`` with method two_stage on mobilenet_v2 at
   full width (LSTM(128), L=12, latency / area / iot / dla, local GA with
   population 20 and 2000 generations), then method ga (population 100,
   5000 generations).  Only the epoch count is cut (the paper uses 5000).
   Stage 1 replays one CUDA graph of its epoch.  Every launch counter is
   set to 0 just before and read just after; each kernel must have
   launched as often as the run implies, replays counted (the LSTM
   backward kernel once per forward step), and no plain version may have
   run on the card.  Each outcome must be feasible, have a monotone
   history of length eps, and its best re-scored by the plain version on
   the CPU must match best_value (rtol 1e-5).  Then, outside the counted
   run: 20 epochs through the graph against 20 eager epochs of the same
   seed, every metric and the final state bit-equal
   (``stage1_graph_vs_eager``); profiler traces of one eager stage-1
   epoch, 20 graphed epochs and 20 local-GA generations
   (``search_traces``): the device's busy share, device events per epoch
   and per generation, and device time by kernel.
6b. The paper's other search engines on the card, on mobilenet_v2 at
   full width (LSTM(128), L = 12, latency / area / dla, LP, seed 0),
   each through ``api.run_search`` with every launch counter set to 0
   just before and read just after: ``a2c`` and ``ppo2`` under the cloud
   budget at eps = 80 with 4 episodes an epoch (20 epochs; the paper
   runs 5000; cut from 100 epochs to make room for phase 6d), and
   ``relaxed`` under iot at eps = 20 (cut from 100; 4 restarts, 25
   Adam steps a round).  Each kernel must have launched exactly as the
   run implies (a2c per epoch: 53 cost launches at (4, 1), 2 x 53 LSTM
   forward steps, rollout and ``eval_sequence``, 53 backward; ppo2: 53,
   53 x 5, 53 x 4; relaxed: one cost launch at (1, N) a hard probe;
   make_env one more) and no plain version may have run on the card.
   Each outcome is checked as phase 6's are: feasible, monotone, and
   re-scored on the CPU (rtol 1e-5).  (Under iot a2c and ppo2 find no
   feasible point in 400 samples, nor do the JAX package's, seed 0.)
   Then one relaxed request (eps = 25) through ``SearchService`` must
   equal its serial run byte for byte, its probes through the per-row
   kernel.  The phase prints ms per epoch / round of each counted run and
   a profiler trace of one short run of each engine (``[engines] trace
   ...``: a2c and ppo2 at 1 epoch, relaxed at 1 round and its 4
   rounding variants, cut from 3 epochs / rounds to make room for phase
   6d; busy share, device events, time by kernel).
6c. The latency-energy frontier on the card.  (a) ``api.run_search``
   with method nsga2 on mobilenet_v2 (53 layers, latency / area / iot /
   dla, LP, seed 0), population 64, archive 128, eps 6,400 (100
   generations), counters set to 0 just before and read just after:
   the per-row kernel must launch once a generation at M = 3,392 (the
   adapter evaluates through ``make_local_costs_eval``), the table
   kernel once (make_env), and no plain version may run on the card; the
   outcome feasible with a monotone history of length eps and its best
   re-scored on the CPU; every frontier point non-dominated, within
   budget and re-scored by the plain version on the CPU (rtol 1e-5).
   Then 10 generations check the engine's own fitness (the table
   kernel at (64, 53)) bit-equal to the adapter's (the per-row kernel).
   It prints ms per generation, a profiler trace of 20 generations
   (busy share, device events a generation, device time by kernel),
   each selection step's ms and device time alone, and front peeling's
   ms at several check intervals (``FRONT_CHECK_INTERVALS``) on the
   first generation's costs and a warm state's.  (b) The counterpart of
   ``benchmarks/bench_frontier.py`` at its quick budget (eps 600, seed
   0, its populations): nsga2 against ``scalarized_frontier_sweep`` (5
   GA runs, w in {0, .25, .5, .75, 1}) on its four standard configs and
   the mix3 co-design row; hypervolume at 1.1x the nadir of both
   frontiers, and both frontiers scored at the reference point stored
   in ``results/frontier.json`` beside the JAX package's HVs; nsga2 >=
   sweep on at least 3 of the 4 (mix3 reported, not counted).  (c) The
   nsga2 request of (a) at eps 640 (streaming progress every 3
   generations) beside a ga request through ``SearchService``: each
   equal to its serial run byte for byte, the frontier and every
   frontier snapshot included; the per-row kernel launched at least
   once and at most once a dispatch.  (d) ``heuristic_a`` and
   ``heuristic_b`` on mobilenet_v2 / iot on the card, exact table-kernel
   launch counts, each value re-scored on the CPU.
6d. Fanout (``repro_torch.distributed.dist_search``) on mobilenet_v2 at
   full width (latency / area / dla, LP, seed 0), every run through
   ``api.run_search`` with the launch counters set to 0 just before and
   read just after.  (a) At 4 shards (``FANOUT_CHECK_RUNS``, cloud):
   ``device`` against ``serial`` for reinforce (eps 100; 200 until the
   room for 8d (c) was made) and ga (population 20, eps 400), ``threads``
   against ``serial`` for reinforce (eps 100) and sa (eps 200): best
   value, history, pe, kt, df and the extras byte for byte, the
   launches exact and equal to serial's (replays counted), no plain
   version on the card, at least one shard feasible.  (b) Wall seconds
   of ``serial``, ``threads`` and ``device`` at 4 and 10 shards for
   reinforce (eps 25, iot; cut from 1000 to make room for phases 8c, 10,
   10b and 8d (c)) and ga (population 100, 250 generations, cloud; cut
   from 500 for 10b), each held to serial's bytes and
   launches; then the device backend's reinforce fleet alone at 1, 4
   and 10 shards: ms a fleet epoch over 50 unprofiled epochs (and its
   rate against one shard's), the host ms one replay call takes with the
   card idle, and a profiler trace of 3, 2 and 1 fleet
   epochs: ms a fleet epoch, the busy share (the union of the kernels'
   device intervals over the wall), device time summed and as that
   union, and the concurrency.  (Under the profiler the shards' kernels
   barely overlap: the trace slows the replays.)
   (c) The search-quality check: each config of
   ``results/search_quality_ref.json`` (the JAX package's seeds 0-9,
   ``tools/search_quality_ref.py``) through fanout at 10 shards, seed 0
   (two_stage on ``threads``, reinforce and ga on ``device``, each its
   own run at the file's eps): each side's median and
   interquartile range, the median ratio, Mann-Whitney U p-values
   (two-sided, and one-sided for the port worse) and the Hodges-Lehmann
   shift with its 95% interval.  It fails where the port is worse at
   one-sided p < 0.01, or infeasible where the reference is feasible on
   more than 2 seeds.  ``--quality-out`` writes the table as JSON, with
   phase 6e's Q4.
6e. ``dist_reinforce`` (episode-parallel REINFORCE,
   ``repro_torch.distributed.dist_search``) on mobilenet_v2 at full
   width (latency / area / iot / dla, LP, seed 0), shards 2 and 6 dead.
   (a, b) On virtual meshes of the card (``DIST_RUNS``): (2, 4) pod x
   data at E = 2 (B = 16, the LSTM backward's single pass) and (4, 4)
   at E = 4 (B = 64, its tiled kernel), each with the pod hop in f32
   and in int8: 20 epochs through ``run_distributed_search``'s runner
   (one CUDA graph, replayed), counted, the launches exact (per epoch N
   table-cost and N LSTM-forward launches at B, and N backward launches
   a backward pass: one, or one a pod with the int8 hop), against 20
   eager epochs of ``make_distributed_epoch`` bit for bit; ms an epoch
   eager and graphed (50 replays, CUDA events), a profiler trace of 10
   graphed epochs (device events, time by kernel, and the busy share as
   the union of the device intervals over the traced wall, as in 6d; cut
   from 20 epochs to fit the phase's time), and ``reinforce`` at
   ``episodes_per_epoch`` 16 and 64 timed the same way beside them.
   (c) A ``ProcessMesh`` world of one rank under NCCL (a ``HashStore``,
   no network): 10 epochs at E = 2 with the bits of
   ``VirtualMesh((1,), ("data",))``.  (d) The quality check's Q4 (the
   file's (2, 4) mesh, E = 2, int8 pod hop, eps 4,000) for seeds 0-9
   through ``api.run_search``, counted, against the JAX package's seeds,
   failing as (c) of phase 6d does.
7. Service path: eight requests (ga x 3, random, grid, sa, bo, reinforce;
   ``SERVICE_REQUESTS``) run serially through ``api.run_search`` on the
   card, then submitted together to
   ``SearchService(ServiceConfig(max_workers=8, window_ms=2.0,
   device="cuda"))``.  The launch counters are set to 0 just before the
   service run and read just after.  Each outcome must equal its serial
   run byte for byte (best_value, history, pe, kt, df); the batcher must
   have fused dispatches and hit its cache; the per-row kernel must have
   launched at least once and at most once per dispatch; no plain version
   may have run on the card.  Then the same requests run through the
   service again under ``DispatchProbe`` (its instrumentation slows them,
   so the timed run above is unprobed): the outcomes must again equal
   the serial runs, and no dispatch may sync the host more than twice, or
   more than once without fresh points.  The phase prints that run's
   dispatch split (``[service] dispatch split``): ms per dispatch, the
   share off the CPU, the time up to the cache lookup, in
   ``eval_point_rows`` and in the aggregation, syncs and torch calls per
   dispatch, the per-row kernel's M over its launches, and each method's
   round trips (``sa``'s is the service's critical path).
7b. HTTP front door and telemetry (``repro_torch.obs``).  (a) Every
   method the port registers (``TELEMETRY_RUNS``: random, grid, bo, sa,
   ga, nsga2, relaxed, reinforce, two_stage, a2c, ppo2, fanout,
   dist_reinforce) on
   mobilenet_v2 at full width through ``api.run_search``, once with
   telemetry off and once on, each run counted: the two outcomes
   byte-identical (best value, history, pe, kt, df, frontier), the
   launches equal and as the run implies, no plain version on the card,
   and ``telemetry["engine"]`` the method with exactly the hard
   evaluations the run implies; reinforce, two_stage and fanout (two
   reinforce shards on the device backend) replay stage 1's CUDA graph,
   and dist_reinforce (phase 6e's (2, 4) mesh, int8 pod hop) its own,
   its launches exact;
   bo, sa and ga run under cloud and must end feasible.
   Then phase 6's 20 graphed epochs against 20 eager ones with telemetry
   on, bit-equal.  (b) ``SearchHTTPService(ServiceConfig(max_workers=8,
   window_ms=2.0, device="cuda"))`` on an ephemeral port, telemetry on:
   ``SERVICE_REQUESTS`` and phase 6c's nsga2 request at eps 640 through
   ``SearchClient`` under two tenants weighted 2:1
   (``HTTP_TENANT_WEIGHTS``), the progress of ``sa`` streamed.  Each
   result over the wire must equal its serial run of phase 7 (nsga2's
   its own) bit for bit, the frontier included; ``/v1/stats`` must add
   up per tenant; ``/metrics`` must pass ``tools/check_telemetry.py``;
   the per-row kernel must have launched at least once and at most once
   a dispatch, each launch inside one ``cost_eval_kernel`` dispatch
   span, and no plain version on the card.  It prints the wall seconds
   beside phase 7's in-process and serial runs, and
   ``cost_eval_kernel``'s dispatches, compiles (first sightings of an M)
   and mean dispatch ms from the registry.  (c) Phase 7's service mix
   again with telemetry on under ``DispatchProbe``: the outcomes equal
   the serial runs and no dispatch syncs the host more than twice, or
   more than once without fresh points; its wall seconds are printed
   beside phase 7's probed and unprobed runs with telemetry off (a
   record, not a gate).
8. LM serving path: qwen2.5-3b at full width (36 layers, d_model 2048,
   GQA 16 / 2, vocab 151,936; random weights from a seed).  (a) float32
   weights, 8 greedy decode steps of 4 requests through the kernel and
   again through the plain version: equal tokens, logits within atol /
   rtol 1e-4.  (b) bfloat16 weights: ``serving.Engine`` serves 16
   ``synthetic_requests`` (prompt lengths 16 and 520, 16 new tokens,
   max_len 1024, max_batch 8), counters set to 0 just before and read
   just after: flash_decode must have launched 36 times per
   ``decode_step`` and no plain version may have run on the card.
   (c) tokens/s, ms per decode step against the step's byte bound, and a
   profiler trace of a few steps (device busy share, flash-decode device
   time per attention).  (d) one decode step of B = 8 with the cache at
   position 32,767 (``init_cache(cfg, 8, 32768)``, no prefill: the
   kernel reads every byte whatever the cache holds): host ms per step
   against the step's bound, and flash decode's device ms per step.
8b. The other families at full width, one model at a time (``LM_FAMILIES``,
   random weights from a seed): phi3.5-MoE (8 of 32 layers: 32 are
   ~84 GB of bf16 weights; 16 until PR 25), qwen3-MoE (2 of 94 layers, 4
   until PR 25; 128 experts, top-8,
   GQA group 16), mamba2-130m, zamba2-1.2b and whisper-small whole, and
   llama-3.2-vision (10 of 100 layers: two groups of four self layers and
   a cross layer).  Audio and vlm attend to seeded random frontend
   features.  (a) float32 weights at one or two layers (one vlm group;
   mamba2, zamba2 and whisper whole), 8 greedy steps of 4 requests
   through the kernel and again through the plain version (mamba2, which
   reaches no kernel: the card against the CPU): equal tokens, logits
   within atol / rtol 1e-4.  (b) bfloat16 weights: ``serving.Engine``
   serves 16 requests (prompt lengths 16 and 64, 16 new tokens, max_len
   256, max_batch 8), counters set to 0 just before and read just after:
   decode steps exact, flash_decode launched once per attention site
   (self and cross) per step, no plain version on the card, every request
   complete and in range.  (c) one step at B = 8 with the cache at
   position 64: ms, the device busy share, the step's bound (an MoE step
   reads the experts its routing picked), tokens/s and peak GB.
8c. Prefill of every family at full width (``PREFILL_*``): phase 8's
   qwen2.5-3b whole and phase 8b's models with its depth cuts (random
   weights from a seed, bfloat16), B = 8 at T = 512 (the direct attention
   path) and T = 2,048 (the blockwise path; whisper's encoder takes its
   ragged blockwise path over 1,500 frames, llama-vision's cross layers
   over 1,601 patches at T = 2,048): ms a prefill, peak GB (above what
   earlier phases left allocated, weights included), the FLOP
   bound and the share of the bf16 peak.  Float32 checks, atol / rtol
   1e-4: each family's prefill logits against the last logits of the
   teacher-forced decode steps (flash decode) on phase 8b's route-check
   depths at B = 2, T = 64 (MoE at capacity factor 8, where neither path
   drops a token), qwen2.5 at 2 layers and T = 1,100 (the blockwise
   prefill), and the blockwise path against the direct one at
   ``BLOCKWISE_SHAPES``.
8d. Sharded serving on an NCCL world of one rank (``HashStore``, no
   network), which runs the whole sharded decode path on the card:
   DTensor placements by ``cache_shardings`` and the rules, ``local_map``
   at the attention, the Mamba step and the MoE dispatch, the partials
   kernel on the rank's cache shard, a one-member all-gather and the
   combine kernel.  (a) qwen2.5-3b whole in float32 through ``serve
   --mesh 1x1`` in process (8 requests, prompt lengths 16 and 64, 16 new
   tokens, max_len 1,024) against the unsharded launcher run on the same
   weights (the same seed): equal tokens, logits within 1e-4 at every
   step; counters set to 0 just before the sharded run and read just
   after: the partials and the combine kernel launched once per
   attention site per step, flash_decode not at all, no plain version on
   the card.  (b) The same in bfloat16 at the prompt-16 bucket only
   (cut to make room for (c)): ms a step of each, the share of equal
   tokens.  (c) phi3.5-MoE (phase 8b's 8 layers) and zamba2-1.2b in
   float32 through ``Engine`` at (a)'s requests, prompt lengths and new
   tokens (``SERVE_SHARDED_FAMILY_RUN``), sharded in place after the
   unsharded run: the check of (a).  (d) Virtual shards
   of one bf16 cache (8, 1,024, 2, 128), 16 query heads: m in {2, 4, 8}
   contiguous shards at positions 0, 100, 511 and 1,023, each shard's
   partials (the neutral one where it holds no valid row) side by side
   and combined, within 1e-5 of ``flash_decode`` and of the plain
   version on the valid rows, two calls bit-equal; each kernel against
   its plain version.  The only combine across several shards on the
   card: two NCCL ranks on one card are refused.
10. Training: ``repro_torch.launch.train`` in process on qwen1.5-0.5b at
   full width, bfloat16 compute with float32 master weights, B = 8, T =
   1,024, 30 steps (cut from 40 for phase 10b) of Adam with the
   launcher's cosine warm-up and a
   checkpoint at step 20, under ``torch.use_deterministic_algorithms(True,
   warn_only=True)``: the loss must fall (the launcher's exit rule).  A
   resume from the step-20 checkpoint must give the uninterrupted run's
   losses within rtol 1e-3 (their bit equality and the operations that
   warn of nondeterminism are recorded); one ``--micro 2`` step from it
   must give the full batch's loss within 1e-2.  ms a step, tokens/s,
   peak GB (above earlier phases' leftovers), a profiler trace of 2
   steps, the share of the bf16 dense peak (model FLOPs 6 N per token
   plus attention, against 989 TFLOP/s).  Then one bfloat16 smoke-size
   step of each other family (MoE, SSD, the shared block, cross-attention
   and the audio encoder backward on the card): loss and parameters
   finite; each step twice from one seed (bit-equal or not is recorded)
   and once under deterministic algorithms (warnings recorded).
10b. Sharded training (``distributed/sharding.py``, ``pipeline.py``,
   ``remat="dots"``): phase 10's model, batch and optimizer, one step a
   case against the unsharded step from the same numbers (loss within
   1e-3 relative, first moments within 1e-2 of the unsharded ones'
   norm; the largest parameter difference and bit equality recorded),
   then timed steps (ms a step, peak GB above what was allocated before
   the case): remat dots and none against full; on an NCCL world of one
   rank (``HashStore``, no network) a (1, 1) ``DeviceMesh``, the
   ``tp``, ``fsdp`` and ``dp`` steps on DTensor parameters and the
   GPipe pipeline at S = 1, M = 2 (held to the unsharded step over the
   same two microbatches, ``train_step_accum``: the halves round alike in
   bfloat16); then two NCCL ranks on the one card:
   whether the world comes up (NCCL may refuse two ranks on one device;
   the outcome is printed), and if it does, the (1, 2) tp step against
   the unsharded one.  This path launches no kernel of the port.
9. Kernel timings at the paths' shapes: CUDA-event ms per call, and
   device µs per launch from a profiler trace of back-to-back calls
   (``search_kernel_times`` for the search path's calls: the cost kernel
   at the rollout's (1, 1) and at (20, 53), the LSTM forward, and its
   backward both alone and under autograd; the backward also on its tiled
   kernel); the per-row kernel at (1, 53), (1, 3392), (1, 5300) and
   (1, 27136) (``MULTI_SHAPES``) as the batcher calls it and on
   contiguous inputs (both forms' device µs), with the batcher's whole
   ``eval_point_rows``; printed as one
   ``{"kernels": [...]}`` line, whose ``launches`` are phase 6's counts
   (phase 7's for the per-row kernel) and ``launches_by_path`` each
   counted run's (phases 6b, 6c, 6d, 6e and 7b included).
   ``tools/profile_search_kernels.py`` runs the same search-path
   measurements on another tree, such as a parent commit.  The line ends
   with the flash-decode kernel's entry (phases 8 and 8b's launches) and
   the partials and combine entries (phase 8d (a)'s launches; timed at
   (a)'s shapes, one rank at the longest request's last step, and on one
   of two shards of phase 8d's bf16 cache at its last position; the
   library call for the partials is the memory-efficient SDPA with its
   log-sum-exp, none for the combine).

The last line is ``{"ok": true, "device": {...}}``.  Nothing here imports
JAX or the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# Float32 operations per design point in csrc/costmodel_eval.cu, counted
# from its source (compares, selects, min/max, ceil/floor and sqrt count
# as one operation each).
COST_OPS_PER_POINT = 224
# Float32 operations per hidden unit in the LSTM tail (3 sigmoids at 4,
# 2 tanh at 1, 4 bias adds, 2 sums of partial products, c' and h').
LSTM_TAIL_OPS_PER_UNIT = 24
# ... and per hidden unit in the backward's elementwise pass (dc_tot, the
# four gate derivatives, dc), counted from csrc/lstm_cell.cu.
LSTM_BWD_TAIL_OPS_PER_UNIT = 24
# LSTM shapes (B, I, H) checked against the plain versions: the search's
# step, a batch of 64 (several forward blocks, several backward chunks),
# a ragged I, a wide I, H = 256, a2c / ppo2's step at B = E = 4 (I =
# 10, and 11 when the search mixes dataflows), and dist_reinforce's step
# on phase 6e's (2, 4) mesh at E = 2 (B = 16; its (4, 4) mesh at E = 4 is
# the B = 64 above).
LSTM_SHAPES = ((1, 10, 128), (64, 10, 128), (8, 11, 128), (16, 130, 128),
               (3, 10, 256), (4, 10, 128), (4, 11, 128), (16, 10, 128))
# The main path's size: stage-1 epochs (= eps; the paper uses 5000, this
# is the only cut), local-GA generations of the two-stage run, and the
# baseline GA's generations at population 100.
EPOCHS = 1000
GA_GENERATIONS = 2000
# Phase 6's check of the CUDA graph against eager epochs, and its trace.
GRAPH_CHECK_EPOCHS = 20
GRAPHED_TRACE_EPOCHS = 20
BASELINE_GA_GENERATIONS = 5000
# Phase 6b: a2c and ppo2 at 20 epochs of 4 episodes (the paper runs 5000
# epochs; this is the only cut, from 100 epochs to make room for phase
# 6d), relaxed at 20 hard evaluations (cut from 100 likewise; its
# default 4 restarts and 25 steps a round), the relaxed request it sends
# through the service (25 probes), and the eps of each traced short run
# (1 epoch; 1 round and the 4 rounding variants; cut from 3 likewise: an
# eager trace's post-processing costs the script more than the run).
AC_EPS, AC_EPISODES, RELAXED_EPS, SERVICE_RELAXED_EPS = 80, 4, 20, 25
ENGINE_TRACE_EPS = {"a2c": 4, "ppo2": 4, "relaxed": 5}
# Phase 6c: NSGA-II on mobilenet_v2 at population 64, archive 128, 100
# generations (eps 6,400), its trace's generations, the check intervals
# of front peeling it times (128 = never before the end), and the
# requests it sends through the service (10 generations beside a GA of
# population 100 and 20 generations).
NSGA2_POPULATION, NSGA2_ARCHIVE, NSGA2_EPS = 64, 128, 6400
NSGA2_TRACE_GENERATIONS = 20
FRONT_CHECK_INTERVALS = (1, 2, 4, 8, 16, 32, 128)
SERVICE_NSGA2_EPS, SERVICE_GA_EPS = 640, 2000
# Phase 6d: fanout on mobilenet_v2 at full width (latency / area / dla,
# LP, seed 0).  (a) Each backend against serial at 4 shards: inner ->
# (eps, inner options, platform, backends held to serial).  (b) Walls of
# serial, threads and device at 4 and 10 shards: reinforce at eps 25
# (iot; cut from 1000 for phases 8c, 10 and 10b, and from 100 for 8d
# (c): the backends stay bit-equal to serial at any eps) and ga at
# population 100 and 250 generations (cloud; cut from 500 for phase 10b);
# shards ->
# epochs of the device backend's traced fleet runs, and the unprofiled
# fleet epochs timed before each trace.  (c) The search-quality
# check: ten shards (seeds 0-9) of each config of the JAX package's
# file, on the backend named here.
FANOUT_ENV = {"objective": "latency", "constraint": "area",
              "scenario": "LP", "dataflow": 0, "levels": 12}
FANOUT_CHECK_SHARDS = 4
FANOUT_CHECK_RUNS = {
    "reinforce": (100, {}, "cloud", ("device", "threads")),
    "ga": (400, {"population": 20}, "cloud", ("device",)),
    "sa": (200, {}, "cloud", ("threads",)),
}
FANOUT_WALL_SHARDS = (4, 10)
FANOUT_WALL_RUNS = {"reinforce": (25, {}, "iot"),
                    "ga": (25_000, {"population": 100}, "cloud")}
FANOUT_TRACE_EPOCHS = {1: 3, 4: 2, 10: 1}
FANOUT_TIMED_EPOCHS = 50
QUALITY_REF = ROOT / "results" / "search_quality_ref.json"
QUALITY_SHARDS = 10
QUALITY_BACKENDS = {"two_stage": "threads", "reinforce": "device",
                    "ga": "device"}
# The quality check fails where the port is worse at one-sided p below
# this, or infeasible where the reference is feasible on more than
# QUALITY_MAX_LOST seeds.
QUALITY_P_WORSE, QUALITY_MAX_LOST = 0.01, 2
# Phase 6e: dist_reinforce on mobilenet_v2 at full width (latency / area /
# iot / dla, LP, seed 0) on virtual meshes of the one card: (mesh shape,
# axes, episodes a device), B = n x E episodes an epoch (the LSTM
# backward's single pass at B = 16, its tiled kernel at B = 64), each
# with the pod hop in f32 and in int8, shards DIST_DEAD dead; the epochs
# of the graph check, of the trace and timed, the epochs of the NCCL
# world of one rank, and the quality config of the JAX package's file
# that phase 6e runs (its ten seeds one after another through the API).
DIST_RUNS = (((2, 4), ("pod", "data"), 2), ((4, 4), ("pod", "data"), 4))
DIST_DEAD = (2, 6)
DIST_EPOCHS = 20
DIST_TRACE_EPOCHS = 10    # cut from 20 to fit the phase's time
DIST_TIMED_EPOCHS = 50
DIST_NCCL_EPOCHS = 10
DIST_QUALITY = "Q4"
# ... and benchmarks/bench_frontier.py's configs at its quick budget:
# (name, workload, env, counts toward "nsga2 >= sweep on 3 of 4").
FRONTIER_EPS = 600
FRONTIER_CONFIGS = (
    ("ncf/cloud/lat", "ncf", dict(platform="cloud"), True),
    ("ncf/iot/energy", "ncf", dict(platform="iot", objective="energy",
                                   constraint="power"), True),
    ("mnasnet/cloud/lat", "mnasnet", dict(platform="cloud"), True),
    ("mobilenet/iot/lat", "mobilenet_v2", dict(platform="iot"), True),
    ("mix3/cloud/lat", "multi_dnn", dict(platform="cloud", mix=True), False),
)
MIX3_ARCHS = ("qwen1p5_0p5b", "whisper_small", "mamba2_130m")
# The paper's six workloads (phase 3's sweeps; the workload registry also
# holds the ten architectures).
PAPER_WORKLOADS = ("gnmt", "mnasnet", "mobilenet_v2", "ncf", "resnet50",
                   "transformer")
# Bytes the per-row cost kernel moves per point: 8 layer fields, pe, kt,
# df in, four costs out, all float32.
MULTI_BYTES_PER_POINT = 4 * (8 + 3 + 4)
# Its timed shapes (1, M): an sa step on mobilenet_v2 (one genome), an
# NSGA-II generation of population 64, a GA generation of population 100,
# a random-search batch of 512.
MULTI_SHAPES = (53, 3392, 5300, 27136)
BF16_FLOP_PER_S = 989e12
# Flash-decode shapes (B, Hq, Hkv, D, T) checked against the plain version:
# the LM path's (qwen2.5-3b, 8 requests, a 520-token prompt), a 32k cache,
# the reference's test shapes, ragged T, head dims 16 / 64 / 256, G = 16
# and G = 12; the split plan's edges on one H100 (132 SMs): T = 513 leaves
# a last split of one key, T = 33 is one tile + 1 key, T = 2049 is one key
# over 32 splits of 64 keys, B * Hkv = 288 gives one split; the
# reference's decode_32k batch and length (4.3 GB of bf16 cache); and the
# other families' paths (phase 8b): whisper's cross-attention (S = 1500),
# llama-3.2-vision's (S = 1601), qwen3-MoE's self-attention (G = 16) and
# zamba2's shared block (G = 1), the last two at the timed step's cache.
FLASH_SHAPES = ((8, 16, 2, 128, 520), (8, 16, 2, 128, 32768),
                (1, 4, 4, 128, 512), (2, 8, 2, 128, 1024),
                (2, 16, 2, 128, 2048), (1, 8, 1, 256, 512),
                (2, 8, 2, 128, 1), (3, 8, 2, 128, 37), (2, 8, 2, 128, 700),
                (2, 4, 4, 16, 37), (2, 16, 16, 64, 65), (1, 32, 2, 256, 129),
                (2, 24, 2, 128, 300), (8, 16, 2, 128, 513),
                (2, 8, 2, 128, 33), (8, 16, 2, 128, 2049),
                (144, 8, 2, 64, 100), (128, 16, 2, 128, 32768),
                (8, 12, 12, 64, 1500), (8, 64, 8, 128, 1601),
                (8, 64, 4, 128, 80), (8, 32, 32, 64, 80))
# ... and timed: the path's shape, a decode-32k length at the path's batch
# and at the reference's, and the reference's largest test shape.
FLASH_TIMED = (((8, 16, 2, 128, 520), "bfloat16"),
               ((8, 16, 2, 128, 32768), "bfloat16"),
               ((128, 16, 2, 128, 32768), "bfloat16"),
               ((2, 16, 2, 128, 2048), "float32"))
# The LM serving path: the model, the float32 route check, the engine run.
LM_ARCH = "qwen2p5_3b"
LM_F32_BATCH, LM_F32_STEPS = 4, 8
LM_REQUESTS, LM_PROMPT_LENS, LM_MAX_NEW = 16, (16, 520), 16
LM_MAX_LEN, LM_MAX_BATCH = 1024, 8
LM_LONG_CACHE = 32768        # phase 8 (d): one step with the cache full
# Phase 8b: the other families at full width, as (arch, layers served,
# layers of the float32 route check); None keeps the published depth.
# Depth is cut only where bfloat16 weights do not fit one 80 GB card
# (phi3.5-MoE: 32 layers are ~83.7 GB; qwen3-MoE: 94 layers ~470 GB;
# llama-3.2-vision: 100 layers ~177 GB), and for the float32 check to what
# fits beside its caches (one or two layers, one vlm group).  The two MoE
# models were cut further (phi3.5 from 16 to 8 layers, qwen3 from 4 to
# 2) to make room for phase 10b: their decode is host-bound, a layer's
# time a layer.
LM_FAMILIES = (("phi3p5_moe_42b", 8, 2), ("qwen3_moe_235b", 2, 1),
               ("mamba2_130m", None, None), ("zamba2_1p2b", None, None),
               ("whisper_small", None, None),
               ("llama3p2_vision_90b", 10, 5))
# Phase 8d: sharded serving on an NCCL world of one rank.  (a) the serve
# launcher's flags for qwen2.5-3b whole in float32, with and without
# ``--mesh 1x1``; (b) the same in bfloat16 with the prompt-16 bucket only
# (cut to make room for (c)'s 64-token prompts: (b) prints, it checks
# nothing); (c) the families whose MoE and Mamba decode sites run
# sharded, in float32, as (arch, layers; None keeps the published depth:
# phi3.5-MoE at phase 8b's cut), with (a)'s request count, prompt lengths
# and new tokens; (d) virtual shards of one bf16 cache (B, Hq, Hkv, D,
# Tmax): each shard count at each position.
SERVE_SHARDED_ARGS = ("--arch", LM_ARCH, "--device", "cuda", "--requests",
                      "8", "--prompt-lens", "16,64", "--max-new", "16",
                      "--max-len", "1024", "--max-batch", "8")
SERVE_SHARDED_BF16_ARGS = tuple(
    "16" if a == "16,64" else a for a in SERVE_SHARDED_ARGS)
SERVE_SHARDED_FAMILIES = (("phi3p5_moe_42b", 8), ("zamba2_1p2b", None))
SERVE_SHARDED_FAMILY_RUN = (8, (16, 64), 16)
SHARD_CACHE = (8, 16, 2, 128, 1024)
SHARD_COUNTS, SHARD_POSITIONS = (2, 4, 8), (0, 100, 511, 1023)
# The partials and combine kernel lines, timed at ((B, Hq, Hkv, D, Tmax),
# shards m, a rank's valid rows, dtype): first (a)'s, one rank whose shard
# is the whole float32 cache at the longest request's last step (64 + 16
# rows), then one of two shards of (d)'s bf16 cache at its last row.
SHARD_TIMED = (((8, 16, 2, 128, 1024), 1, 80, "float32"),
               (SHARD_CACHE, 2, 512, "bfloat16"))
# Phase 8b's engine runs take phase 8's request count, new tokens and
# batch, with these prompt lengths and cache; (c) times a step here.
FAMILY_PROMPT_LENS, FAMILY_MAX_LEN, FAMILY_STEP_POS = (16, 64), 256, 64
# Phase 8c: prefill of every family at full width -- phase 8's qwen2.5-3b
# whole and phase 8b's models with its depth cuts -- at B = 8, T = 512
# (the direct attention path) and T = 2,048 (the blockwise path; whisper's
# encoder takes the ragged blockwise path over its 1,500 frames at either
# T, llama-vision's cross-attention over 1,601 patches at T = 2,048).  The
# float32 checks: prefill against the teacher-forced decode on phase 8b's
# route-check depths (qwen2.5 at 2 layers) at B = 2, T = 64, and at T =
# 1,100 for qwen2.5 (blockwise prefill against flash decode); then the
# blockwise path against the direct one on full-width shapes.
PREFILL_BATCH, PREFILL_LENS = 8, (512, 2048)
PREFILL_CHECK_BATCH, PREFILL_CHECK_T, PREFILL_CHECK_LONG_T = 2, 64, 1100
PREFILL_TIMED = 3
# (name, B, T, S, Hq, Hkv, hd, causal) of the blockwise-against-direct
# check: qwen2.5's self-attention at T = 2,048, whisper's encoder over
# 1,500 frames, llama-vision's cross-attention over 1,601 patches.
BLOCKWISE_SHAPES = (("qwen2p5_self", 2, 2048, 2048, 16, 2, 128, True),
                    ("whisper_encoder", 2, 1500, 1500, 12, 12, 64, False),
                    ("llama_vision_cross", 2, 2048, 1601, 64, 8, 128, False))
# Phase 10: ``repro_torch.launch.train`` in process on qwen1.5-0.5b at full
# width in bfloat16 (float32 master weights), B = 8, T = 1,024, 30 steps of
# Adam with the launcher's cosine warm-up over 20, a checkpoint at step 20;
# then a resume from it (losses held to the uninterrupted run's, rtol
# TRAIN_RESUME_RTOL, and their bit equality recorded), one --micro 2 step
# from it (loss within TRAIN_MICRO_RTOL of the full batch's: the halves
# round differently in bfloat16), and one smoke-size bfloat16 step of each
# other family at B = 2, T = 64.
TRAIN_ARCH, TRAIN_STEPS, TRAIN_RESUME_AT = "qwen1p5_0p5b", 30, 20
TRAIN_ARGS = ("--batch", "8", "--seq", "1024", "--warmup", "20")
TRAIN_RESUME_RTOL, TRAIN_MICRO_RTOL = 1e-3, 1e-2
TRAIN_FAMILIES = ("phi3p5_moe_42b", "qwen3_moe_235b", "mamba2_130m",
                  "zamba2_1p2b", "whisper_small", "llama3p2_vision_90b")
TRAIN_SMOKE_BATCH, TRAIN_SMOKE_T = 2, 64
# Phase 10b: phase 10's model, batch and optimizer, one step a case against
# the unsharded step from the same numbers (loss within TRAIN_RESUME_RTOL;
# first moments, 0.1 x the clipped gradient, within SHARDED_REL_TOL of the
# unsharded ones' norm), then SHARDED_TIMED timed steps; the pipeline at
# S = 1 with PP_MICRO microbatches; two NCCL ranks on the one card, given
# TWO_RANK_TIMEOUT_S.
SHARDED_MODES, SHARDED_TIMED, SHARDED_REL_TOL = ("tp", "fsdp", "dp"), 2, 1e-2
PP_MICRO, TWO_RANK_TIMEOUT_S = 2, 120
# The service path: (method, workload, eps, seed, options), all at
# latency / area / iot / dla, LP.  Requests 1 and 2 are the same query
# from two users.
SERVICE_REQUESTS = (
    ("ga", "mobilenet_v2", 50_000, 0, {"population": 100}),
    ("ga", "mobilenet_v2", 50_000, 0, {"population": 100}),
    ("ga", "resnet50", 50_000, 1, {"population": 100}),
    ("random", "mobilenet_v2", 5_000, 0, {}),
    ("grid", "ncf", 5_000, 0, {}),
    ("sa", "mobilenet_v2", 2_000, 0, {}),
    ("bo", "mnasnet", 1_000, 0, {}),
    ("reinforce", "ncf", 50, 0, {}),
)


# Phase 7b (a): every registered method on mobilenet_v2 at full width,
# once with telemetry off and once on: (eps, options, platform).  a2c and
# ppo2 under the cloud budget as in phase 6b, and bo, sa and ga too: under
# iot all three end infeasible at these budgets, and their on / off
# comparison would hold infeasible traces only (``TELEMETRY_FEASIBLE``
# must end feasible); two_stage's local GA runs population 20 x 100
# generations after its 40 epochs; fanout runs two reinforce shards on
# the device backend; dist_reinforce runs phase 6e's (2, 4) mesh with the
# int8 pod hop for 10 epochs (its mesh is given as (shape, axes)).
TELEMETRY_RUNS = {
    "random": (1024, {}, "iot"),
    "grid": (1024, {}, "iot"),
    "bo": (160, {}, "cloud"),
    "sa": (400, {}, "cloud"),
    "ga": (2000, {"population": 100}, "cloud"),
    "nsga2": (640, {"population": 64, "archive": 128}, "iot"),
    "relaxed": (10, {}, "iot"),
    "reinforce": (40, {}, "iot"),
    "two_stage": (40, {"ga": {"population": 20, "generations": 100}}, "iot"),
    "a2c": (40, {"episodes_per_epoch": 4}, "cloud"),
    "ppo2": (40, {"episodes_per_epoch": 4}, "cloud"),
    "fanout": (40, {"inner": "reinforce", "n_shards": 2,
                    "backend": "device"}, "iot"),
    "dist_reinforce": (160, {"mesh": ((2, 4), ("pod", "data")),
                             "episodes_per_device": 2,
                             "compress_pod_axis": True,
                             "straggler_mask": [i not in DIST_DEAD
                                                for i in range(8)]}, "iot"),
}
TELEMETRY_FEASIBLE = ("bo", "sa", "ga")
# Phase 7b (b): the front door's tenants and WRR weights; each request of
# SERVICE_REQUESTS goes to the tenant at its index, the nsga2 request to
# the last; the request whose progress is streamed; the client's timeout.
HTTP_TENANT_WEIGHTS = (("interactive", 2), ("batch", 1))
HTTP_TENANTS = ("batch", "batch", "batch", "interactive", "interactive",
                "interactive", "interactive", "interactive", "batch")
HTTP_STREAMED = 5            # sa, the longest
HTTP_TIMEOUT_S = 300.0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def time_ms_cycle(fn, arg_sets, iters, warmup=10):
    """Mean milliseconds per call of ``fn(*args)`` on the card (CUDA
    events), cycling through ``arg_sets`` so that the inputs do not stay
    in the 50 MB L2 cache from one call to the next."""
    import torch

    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms(fn, iters, warmup=20):
    """Mean milliseconds per call of ``fn()`` on the card (CUDA events)."""
    return time_ms_cycle(fn, [()], iters, warmup)


def phase_device():
    import torch

    check(torch.cuda.is_available(), "CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    return line


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build()
    total = time.perf_counter() - t0
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"total {total:.2f}s")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    return total


def _layers_table(arr, dev):
    import torch

    return torch.as_tensor(arr, dtype=torch.float32, device=dev).T.contiguous()


def phase_cost_kernel(dev):
    """Kernel vs plain version on the card; returns the worst errors."""
    import numpy as np
    import torch

    from repro_torch.costmodel import dataflows as dfl
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, ref

    worst = {"abs": 0.0, "rel": 0.0, "points": 0}

    def compare(layers_t, pe, kt, df, what, forms=None):
        """The kernel on ``forms`` (the same values broadcast, strided or
        by value; default the dense inputs) against the plain version on
        the dense (B, N) inputs."""
        got = costmodel_eval.cost_eval(layers_t, *(forms or (pe, kt, df)))
        want = ref.cost_eval_ref(layers_t, pe, kt, df)
        torch.cuda.synchronize()
        for g, w, field in zip(got, want, ("lat", "en", "area", "pw")):
            ok = torch.isclose(g, w, rtol=1e-5, atol=1e-2)
            check(bool(ok.all()), f"cost kernel disagrees on {what} {field}: "
                  f"max abs {float((g - w).abs().max())}")
            diff = (g - w).abs()
            worst["abs"] = max(worst["abs"], float(diff.max()))
            worst["rel"] = max(worst["rel"], float(
                (diff / w.abs().clamp_min(1e-30)).max()))
        worst["points"] += pe.numel()

    L = 12
    pe_g, kt_g = np.meshgrid(dfl.pe_levels(L), dfl.kt_levels(L),
                             indexing="ij")
    for name in PAPER_WORKLOADS:
        arr = layers_lib.layers_to_array(workloads.get_workload(name))
        N = arr.shape[0]
        lt = _layers_table(arr, dev)
        pe = torch.tensor(np.tile(pe_g.reshape(-1, 1), (1, N)),
                          dtype=torch.float32, device=dev)
        kt = torch.tensor(np.tile(kt_g.reshape(-1, 1), (1, N)),
                          dtype=torch.float32, device=dev)
        for df in range(3):
            dense = (pe, kt, torch.full_like(pe, float(df)))
            compare(lt, *dense, f"{name} df={df}")
            # The level grid's pe and kt are constant along N: (144, 1)
            # columns and a dataflow by value, as the searches pass them.
            compare(lt, *dense, f"{name} df={df} broadcast",
                    forms=(pe[:, :1], kt[:, :1], float(df)))

    rng = np.random.default_rng(0)
    mobilenet = layers_lib.layers_to_array(workloads.get_workload(
        "mobilenet_v2"))
    for (B, N), arr in (((4096, 53), mobilenet), ((1, 1), None),
                        ((3, 7), None), ((13, 130), None)):
        arr = _rand_layers(rng, N) if arr is None else arr
        f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, N)),
                                        dtype=torch.float32, device=dev)
        dense = (f(1, 161), f(1, 17), f(0, 3))
        compare(_layers_table(arr, dev), *dense, f"random ({B}, {N})")
        # Strided: every other column of a wider array, and transposes.
        wide = dense[0].repeat_interleave(2, dim=1)
        compare(_layers_table(arr, dev), *dense,
                f"random ({B}, {N}) strided",
                forms=(wide[:, ::2], dense[1].T.contiguous().T,
                       dense[2].T.contiguous().T))
    # The engines' shapes on mobilenet_v2: each layer row at (4, 1), an
    # a2c / ppo2 rollout step of E = 4 (pe, kt as columns, df by value),
    # and the whole table at (1, 53), a relaxed hard probe.
    f = lambda lo, hi, B, N: torch.tensor(rng.integers(lo, hi, (B, N)),
                                          dtype=torch.float32, device=dev)
    for t in range(mobilenet.shape[0]):
        dense = (f(1, 161, 4, 1), f(1, 17, 4, 1), torch.zeros((4, 1),
                                                              device=dev))
        compare(_layers_table(mobilenet[t:t + 1], dev), *dense,
                f"mobilenet_v2 layer {t} at (4, 1)",
                forms=(*dense[:2], 0.0))
    compare(_layers_table(mobilenet, dev), f(1, 161, 1, 53),
            f(1, 17, 1, 53), f(0, 3, 1, 53), "mobilenet_v2 at (1, 53)")
    log(f"[cost] kernel == plain on {worst['points']} points (half of them "
        f"read broadcast or strided): max abs err {worst['abs']:.6g}, max "
        f"rel err {worst['rel']:.3g} (rtol 1e-5, atol 1e-2)")
    return worst


def _rand_layers(rng, n):
    """n random conv / dwconv / gemm layer rows, (n, NUM_FIELDS)."""
    from repro_torch.costmodel import layers as layers_lib

    out = []
    for _ in range(n):
        t = rng.integers(0, 3)
        if t == 2:
            out.append(layers_lib.LayerSpec.gemm(
                *(int(v) for v in rng.integers(1, 512, 3))))
        elif t == 1:
            out.append(layers_lib.LayerSpec.dwconv(
                int(rng.integers(1, 256)), int(rng.integers(7, 64)),
                int(rng.integers(7, 64)), 3, 3))
        else:
            out.append(layers_lib.LayerSpec.conv(
                int(rng.integers(1, 256)), int(rng.integers(1, 256)),
                int(rng.integers(7, 64)), int(rng.integers(7, 64)), 3, 3))
    return layers_lib.layers_to_array(out)


def _flat_points(arr, M, rng, dev):
    """M points cycling over the layer rows of ``arr``, with random raw
    pe (1..160), kt (1..16) and df (0..2), as flat kernel inputs."""
    import numpy as np
    import torch

    layers = np.tile(arr, (-(-M // len(arr)), 1))[:M]
    f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, M),
                                    dtype=torch.float32, device=dev)
    return (torch.as_tensor(layers, dtype=torch.float32, device=dev),
            f(1, 161), f(1, 17), f(0, 3))


def phase_multi_kernel(dev):
    """Per-row kernel vs plain version on the card; returns the worst
    errors."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.costmodel import dataflows as dfl
    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, ops, ref

    worst = {"abs": 0.0, "rel": 0.0, "points": 0, "forms": 0}

    def compare(layers, pe, kt, df, what):
        """The kernel on contiguous (M, 8) and (M,) inputs against the
        plain version; then the same values read in place from one packed
        (M, 11) row block (the service's upload, stride 11), through the
        wrapper and through ``ops.batched_cost_multi`` as (M, 4) rows and
        as four planes, bit-equal to the contiguous call."""
        got = costmodel_eval.cost_eval_multi(layers, pe, kt, df)
        want = ref.cost_eval_multi_ref(layers, pe, kt, df)
        torch.cuda.synchronize()
        for g, w, field in zip(got.unbind(1), want,
                               ("lat", "en", "area", "pw")):
            ok = torch.isclose(g, w, rtol=1e-5, atol=1e-2)
            check(bool(ok.all()), f"per-row cost kernel disagrees on {what} "
                  f"{field}: max abs {float((g - w).abs().max())}")
            diff = (g - w).abs()
            worst["abs"] = max(worst["abs"], float(diff.max()))
            worst["rel"] = max(worst["rel"], float(
                (diff / w.abs().clamp_min(1e-30)).max()))
        worst["points"] += pe.numel()
        block = torch.cat([layers, pe[:, None], kt[:, None], df[:, None]], 1)
        cols = (block[:, :8], block[:, 8], block[:, 9], block[:, 10])
        for form, out in (
                ("wrapper", costmodel_eval.cost_eval_multi(*cols)),
                ("rows", ops.batched_cost_multi(*cols, interleaved=True)),
                ("planes", torch.stack(ops.batched_cost_multi(*cols), 1))):
            check(torch.equal(out, got), f"per-row kernel on {what}: the "
                  f"(M, 11) row block ({form}) differs from the contiguous "
                  "call")
            worst["forms"] += 1
        return got

    def broadcast_forms(arr, B, what):
        """One workload's (N, 8) table broadcast over B rows, pe (B, N), kt
        a (B, 1) column, df a number, through ``ops.batched_cost_multi``
        as rows and as planes: bit-equal to the table kernel, as is the
        dense call, which holds to the plain version."""
        n = len(arr)
        table = torch.as_tensor(arr, dtype=torch.float32, device=dev)
        f = lambda lo, hi, c: torch.tensor(rng.integers(lo, hi, (B, c)),
                                           dtype=torch.float32, device=dev)
        pe, kt_col, d = f(1, 161, n), f(1, 17, 1), float(rng.integers(0, 3))
        kt = kt_col.expand(B, n)
        dense = compare(table.repeat(B, 1), pe.reshape(-1),
                        kt.reshape(-1), torch.full((B * n,), d, device=dev),
                        f"{what} dense")
        want = costmodel_eval.cost_eval(_layers_table(arr, dev), pe, kt_col,
                                        d)
        check(torch.equal(dense.T.reshape(4, B, n), want),
              f"per-row kernel differs from the table kernel on {what}")
        for form, out in (
                ("rows", ops.batched_cost_multi(
                    table, pe, kt_col, d, interleaved=True).permute(2, 0, 1)),
                ("planes", torch.stack(ops.batched_cost_multi(
                    table, pe, kt_col, d)))):
            check(torch.equal(out, want), f"per-row kernel on {what}: "
                  f"broadcast and number operands ({form}) differ from the "
                  "table kernel")
            worst["forms"] += 1

    rng = np.random.default_rng(2)
    # The six paper workloads as ragged rows, padded with repeat = 0 rows.
    packs = [layers_lib.layers_to_array(workloads.get_workload(n))
             for n in PAPER_WORKLOADS]
    N = max(len(p) for p in packs)
    pad = dataclasses.replace(layers_lib.LayerSpec.gemm(1, 1, 1),
                              repeat=0).as_row()
    rows = np.stack([np.concatenate([p, np.tile(pad, (N - len(p), 1))])
                     for p in packs]).astype(np.float32)      # (6, N, 8)
    draws = 24
    layers = torch.as_tensor(np.tile(rows, (draws, 1, 1)).reshape(-1, 8),
                             device=dev)
    levels = lambda table: torch.as_tensor(
        table[rng.integers(0, len(table), layers.shape[0])],
        dtype=torch.float32, device=dev)
    real = np.tile(np.arange(N)[None] < np.array([len(p) for p in packs])[
        :, None], (draws, 1)).reshape(-1)
    for df in range(3):
        pe, kt = levels(dfl.pe_levels(12)), levels(dfl.kt_levels(12))
        got = compare(layers, pe, kt, torch.full_like(pe, float(df)),
                      f"ragged paper rows df={df}")
        pad_mask = torch.as_tensor(~real, device=dev)
        check(bool((got[pad_mask] == 0).all()),
              "per-row cost kernel: a repeat = 0 padding row is not 0")
        # The same rows as (B, N, 8) and (B, N) views of one (B, N, 11)
        # block, pe a number: bit-equal, padding rows 0, rows and planes.
        B = layers.shape[0] // N
        block = torch.cat([layers, kt[:, None], torch.full_like(
            kt, float(df))[:, None]], 1).reshape(B, N, 10)
        p0 = float(pe[0])
        dense = costmodel_eval.cost_eval_multi(
            layers, torch.full_like(pe, p0), kt, torch.full_like(pe, float(
                df)))
        views = (block[..., :8], p0, block[..., 8], block[..., 9])
        for form, out in (
                ("rows", ops.batched_cost_multi(*views, interleaved=True)),
                ("planes", torch.stack(ops.batched_cost_multi(*views), -1))):
            out = out.reshape(-1, 4)
            check(torch.equal(out, dense), f"per-row kernel on ragged paper "
                  f"rows df={df}: (B, N) views ({form}) differ from the "
                  "contiguous call")
            check(bool((out[pad_mask] == 0).all()), "per-row cost kernel: a "
                  f"repeat = 0 padding row is not 0 ({form})")
            worst["forms"] += 1

    mobilenet = layers_lib.layers_to_array(workloads.get_workload(
        "mobilenet_v2"))
    for M in (NSGA2_POPULATION * len(mobilenet), 5300, 27136):
        compare(*_flat_points(mobilenet, M, rng, dev),
                f"random raw points (1, {M})")
    # NSGA-II's mix3 co-design rows: a population of 30 over the ragged
    # three-architecture workload, per-layer dataflows.
    mix3 = layers_lib.layers_to_array(workloads.multi_dnn(list(MIX3_ARCHS),
                                                         tokens=32))
    compare(*_flat_points(mix3, 30 * len(mix3), rng, dev),
            f"mix3 rows (30 x {len(mix3)})")
    for B, n in ((1, 1), (3, 7), (13, 130)):
        compare(*_flat_points(_rand_layers(rng, B * n), B * n, rng, dev),
                f"random ragged ({B}, {n})")

    # Rows that all carry one workload: bit-equal to the table kernel.
    for name in PAPER_WORKLOADS:
        arr = layers_lib.layers_to_array(workloads.get_workload(name))
        n = len(arr)
        B = 100
        f = lambda lo, hi: torch.tensor(rng.integers(lo, hi, (B, n)),
                                        dtype=torch.float32, device=dev)
        pe, kt, df = f(1, 161), f(1, 17), f(0, 3)
        table = costmodel_eval.cost_eval(_layers_table(arr, dev), pe, kt, df)
        per_row = costmodel_eval.cost_eval_multi(
            torch.as_tensor(np.tile(arr, (B, 1)), dtype=torch.float32,
                            device=dev),
            pe.reshape(-1), kt.reshape(-1), df.reshape(-1))
        torch.cuda.synchronize()
        check(torch.equal(table, per_row.T.reshape(4, B, n)),
              f"per-row kernel differs from the table kernel on {name}")
        broadcast_forms(arr, 20, f"{name} (20 rows)")
    log(f"[cost_multi] kernel == plain on {worst['points']} points: max abs "
        f"err {worst['abs']:.6g}, max rel err {worst['rel']:.3g} (rtol "
        "1e-5, atol 1e-2); padding rows 0; one-workload rows bit-equal to "
        f"the table kernel; {worst['forms']} strided, broadcast or number "
        "forms, as rows and as planes, bit-equal to the contiguous call")
    return worst


def _lstm_inputs(B, I, H, dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda *s, scale=0.1: torch.randn(s, generator=gen,
                                          device=dev) * scale
    return (f(B, I, scale=1.0), f(B, H), f(B, H), f(I, 4 * H), f(H, 4 * H),
            f(4 * H))


def phase_lstm_kernel(dev):
    """The LSTM forward and backward kernels against their plain versions
    (atol 1e-5) at ``LSTM_SHAPES``: the forward's h', c' and its saved
    gates, the backward from those gates (against the plain version in its
    signature and the one that recomputes the gates), two backward calls
    bit-equal, and the autograd Function against autograd through the
    plain version."""
    import torch

    from repro_torch.kernels import lstm_cell, ref

    worst = {"fwd": 0.0, "gates": 0.0, "bwd": 0.0, "grad": 0.0}

    def err(got, want, what, key):
        for g, w in zip(got, want):
            e = float((g - w).abs().max()) if g.numel() else 0.0
            check(bool(g.isfinite().all()) and e <= 1e-5,
                  f"LSTM {what} disagrees: max abs {e}")
            worst[key] = max(worst[key], e)

    for k, (B, I, H) in enumerate(LSTM_SHAPES):
        args = _lstm_inputs(B, I, H, dev, seed=k)
        out = lstm_cell.lstm_cell(*args)
        h2, c2, gates = out[0], out[1], out[2:]
        err((h2, c2), ref.lstm_cell_ref(*args), f"forward at {(B, I, H)}",
            "fwd")
        err((gates,), ref.lstm_cell_saved_ref(*args)[2:],
            f"saved gates at {(B, I, H)}", "gates")
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + k)
        dh, dc = (torch.randn((B, H), generator=gen, device=dev)
                  for _ in range(2))
        for tiled in (False, True):
            what = f"{'tiled ' if tiled else ''}backward at {(B, I, H)}"
            bwd = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc,
                                          tiled=tiled)
            again = lstm_cell.lstm_cell_bwd(*args[:5], gates, dh, dc,
                                            tiled=tiled)
            err(bwd, ref.lstm_cell_bwd_saved_ref(*args[:5], gates, dh, dc),
                what, "bwd")
            err(bwd, ref.lstm_cell_bwd_ref(*args, dh, dc),
                f"{what} vs the recomputing formula", "bwd")
            check(all(torch.equal(a, b) for a, b in zip(bwd, again)),
                  f"LSTM {what}: two calls differ")
        leaves = [a.clone().requires_grad_() for a in args]
        leaves_ref = [a.clone().requires_grad_() for a in args]
        out_k = lstm_cell.LSTMCellFn.apply(*leaves)
        out_p = ref.lstm_cell_ref(*leaves_ref)
        err(torch.autograd.grad(out_k, leaves, (dh, dc)),
            torch.autograd.grad(out_p, leaves_ref, (dh, dc)),
            f"gradient through LSTMCellFn at {(B, I, H)}", "grad")
    log(f"[lstm] kernels == plain: max abs err forward {worst['fwd']:.3g}, "
        f"saved gates {worst['gates']:.3g}, backward {worst['bwd']:.3g}, "
        f"gradient through LSTMCellFn {worst['grad']:.3g} (atol 1e-5); the "
        "single-pass and the tiled backward each bit-equal over two calls")
    return worst


def _attn_inputs(shape, dt, dev, seed):
    import torch

    B, Hq, Hkv, D, T = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = lambda *s: torch.randn(s, generator=gen, device=dev).to(dt)
    return f(B, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D)


def phase_flash_kernel(dev):
    """Flash-decode kernel vs its plain version; returns the worst errors.

    atol 1e-4 in both types: the kernel and the plain version read the same
    bf16 (or f32) values and both compute in float32, so only the order of
    the sums differs."""
    import torch

    from repro_torch.kernels import flash_decode, ops, ref

    worst = {"float32": 0.0, "bfloat16": 0.0, "cases": 0, "split_cases": 0}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def compare(q, k, v, what):
        S, _ = flash_decode.plan_splits(q.shape[0], k.shape[2], k.shape[1],
                                        sms)
        combines = ops.launch_counts()["flash_decode_combine"]
        got = flash_decode.flash_decode(q, k, v)
        combined = ops.launch_counts()["flash_decode_combine"] - combines
        check(combined == int(S > 1), f"flash-decode on {what}: {S} splits, "
              f"combine launched {combined} times")
        again = flash_decode.flash_decode(q, k, v)
        want = ref.flash_decode_ref(q, k, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(got.isfinite().all()) and err <= 1e-4,
              f"flash-decode kernel disagrees on {what}: max abs {err}")
        check(torch.equal(got, again), f"flash-decode on {what}: two calls "
              "on the same inputs differ")
        key = str(q.dtype).split(".")[-1]
        worst[key] = max(worst[key], err)
        worst["cases"] += 1
        worst["split_cases"] += S > 1

    for i, shape in enumerate(FLASH_SHAPES):
        for dt in (torch.float32, torch.bfloat16):
            compare(*_attn_inputs(shape, dt, dev, i), f"{shape} {dt}")
            torch.cuda.empty_cache()
    # Views cache[:, :L] of a longer cache, as the decode step passes them.
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = _attn_inputs((8, 16, 2, 128, 1024), dt, dev, 99)
        for L in (1, 300, 520, 1024):
            compare(q, k[:, :L], v[:, :L], f"view [:, :{L}] {dt}")
    log(f"[flash] kernel == plain on {worst['cases']} cases "
        f"({worst['split_cases']} split): max abs err float32 "
        f"{worst['float32']:.3g}, bfloat16 {worst['bfloat16']:.3g} (atol "
        "1e-4); two calls bit-equal; combine launched iff split")
    return worst


def _rescore_on_cpu(out, ecfg, wl):
    """Re-score an outcome's best with the plain version on the CPU."""
    from repro_torch.core import env as env_lib

    env = env_lib.make_env(wl, ecfg, device="cpu")
    perf, cons, _ = env_lib.genome_cost(env, ecfg, out.pe, out.kt, out.df)
    check(abs(float(perf) - out.best_value) <= 1e-5 * abs(out.best_value),
          f"{out.method}: re-scored best {float(perf)} != {out.best_value}")
    check(float(cons) <= float(env.budget) * (1 + 1e-6),
          f"{out.method}: reported best is infeasible on re-scoring")


def _check_outcome(out, eps):
    import numpy as np

    check(out.feasible, f"{out.method}: no feasible point found")
    check(len(out.history) == eps, f"{out.method}: history length")
    check(bool(np.all(out.history[1:] <= out.history[:-1])),
          f"{out.method}: history not monotone")
    check(out.history[-1] == out.best_value,
          f"{out.method}: history[-1] != best_value")


def phase_main_path(epochs, ga_generations):
    import torch

    from repro_torch import api
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import ops, ref

    wl = workloads.get_workload("mobilenet_v2")
    N = len(wl)
    ecfg = api.EnvConfig(objective="latency", constraint="area",
                         platform="iot", dataflow=0, levels=12)
    stamps = {}

    def stage_clock(trial):
        stamps.setdefault("stage1_end", time.perf_counter())

    two = api.SearchRequest(
        workload=wl, env=ecfg, eps=epochs, seed=0, method="two_stage",
        options={"ga": {"population": 20, "generations": ga_generations}},
        on_progress=stage_clock, progress_every=epochs, device="cuda")
    # The baseline GA gets 100 x 5000 samples: under the iot budget a
    # random genome is feasible about once in 1500 draws, and with far fewer
    # generations the GA can end without a feasible point.
    ga_pop, ga_gens = 100, BASELINE_GA_GENERATIONS
    ga = api.SearchRequest(workload=wl, env=ecfg, eps=ga_pop * ga_gens,
                           seed=0, method="ga",
                           options={"population": ga_pop}, device="cuda")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out_two = api.run_search(two)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out_ga = api.run_search(ga)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = ops.launch_counts()
    plain_on_card = dict(ref.cuda_calls)

    # make_env evaluates C_max once per search; stage 1 scores every layer
    # of every epoch; each GA generation is one population evaluation.
    want_cost = (1 + N * epochs + ga_generations) + (1 + ga_gens)
    check(counts["cost_eval"] == want_cost,
          f"cost kernel launched {counts['cost_eval']} times, the run "
          f"implies {want_cost}")
    check(counts["lstm_cell"] >= N * epochs,
          f"LSTM kernel launched {counts['lstm_cell']} times, fewer than "
          f"{N} x {epochs}")
    # Stage 1 is the run's only LSTM user: one backward launch per step.
    check(counts["lstm_cell_bwd"] == counts["lstm_cell"],
          f"LSTM backward kernel launched {counts['lstm_cell_bwd']} times "
          f"for {counts['lstm_cell']} forward steps")
    check(plain_on_card["lstm_cell_bwd_ref"] == 0
          and all(v == 0 for v in plain_on_card.values()),
          f"a plain version ran on the card: {plain_on_card}")
    for out, eps in ((out_two, epochs), (out_ga, ga.eps)):
        _check_outcome(out, eps)
        _rescore_on_cpu(out, ecfg, wl)
        log(json.dumps({
            "method": out.method, "best_value": out.best_value,
            "stage1_value": out.extras.get("stage1_value"),
            "initial_valid_value": out.extras.get("initial_valid_value"),
            "samples_to_convergence": out.samples_to_convergence,
            "wall_seconds": out.wall_seconds}))
    s1 = stamps["stage1_end"] - t0
    timing = {"epochs": epochs, "ga_generations": ga_generations,
              "two_stage_s": t1 - t0, "stage1_s": s1,
              "stage1_ms_per_epoch": 1e3 * s1 / epochs,
              "stage2_ms_per_generation": 1e3 * (t1 - t0 - s1)
              / ga_generations,
              "ga_s": t2 - t1, "ga_generations_baseline": ga_gens}
    log(f"[main] launches {json.dumps(counts)}; plain versions on the card "
        f"{json.dumps(plain_on_card)}; {json.dumps(timing)}")
    # After the counted run: the graph against eager epochs, then traces
    # of a few epochs and generations.
    dev = torch.device("cuda", 0)
    timing["graph_vs_eager"] = stage1_graph_vs_eager(dev)
    traces = search_traces(dev)
    for name, tr in traces.items():
        log(f"[main] trace of {tr['calls']} x {name}: "
            f"{tr['unprofiled_ms']:.3f} ms each unprofiled, device "
            f"{tr['device_us_per_call'] / 1e3:.3f} ms, busy "
            f"{100 * tr['device_busy_share_unprofiled']:.1f}% of the "
            f"unprofiled time, {tr['launches_per_call']:.1f} device events "
            f"each; by kernel (µs, launches each): "
            f"{json.dumps(tr['kernels'][:8])}")
    timing["traces"] = traces
    return counts, timing


def _stage1_setup(dev, epochs=EPOCHS):
    """Phase 6's stage 1: mobilenet_v2 at full width (LSTM(128), L = 12,
    latency / area / iot / dla, LP, E = 1, seed 0)."""
    from repro_torch import api
    from repro_torch.core import env as env_lib
    from repro_torch.core import policy as policy_lib
    from repro_torch.core import reinforce
    from repro_torch.costmodel import workloads

    wl = workloads.get_workload("mobilenet_v2")
    ecfg = api.EnvConfig(objective="latency", constraint="area",
                         platform="iot", dataflow=0, levels=12)
    pcfg = policy_lib.PolicyConfig(obs_dim=ecfg.obs_dim, mix=ecfg.mix,
                                   levels=ecfg.levels)
    rcfg = reinforce.ReinforceConfig(epochs=epochs, seed=0)
    return wl, ecfg, pcfg, rcfg, env_lib.make_env(wl, ecfg, dev)


def stage1_graph_vs_eager(dev, epochs=GRAPH_CHECK_EPOCHS):
    """``epochs`` stage-1 epochs through ``reinforce.run_search`` (one CUDA
    graph, replayed) against as many epochs of ``make_epoch_fn`` run
    eagerly from the same seed: every metric of every epoch and the final
    state (params, Adam state, best, epoch, generator) must be
    bit-equal."""
    import torch

    from repro_torch.core import reinforce
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1_setup(dev, epochs)
    t0 = time.perf_counter()
    got, hist = reinforce.run_search(wl, ecfg, rcfg, pcfg, env=env)
    graphed_s = time.perf_counter() - t0
    opt = optim.Adam(lr=rcfg.lr)
    st = reinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    epoch_fn = reinforce.make_epoch_fn(ecfg, pcfg, rcfg, env, opt)
    metrics = []
    t0 = time.perf_counter()
    for _ in range(epochs):
        st, m = epoch_fn(st)
        metrics.append(m)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    for k in reinforce.METRICS:
        want = torch.stack([m[k] for m in metrics]).cpu().numpy()
        check(hist[k].tobytes() == want.tobytes(), f"graphed stage 1: "
              f"{k} differs from the eager epochs: {hist[k]} vs {want}")
    same = lambda xs, ys: all(torch.equal(a, b) for a, b in zip(xs, ys))
    check(same(got.params.parameters(), st.params.parameters()),
          "graphed stage 1: params differ from the eager epochs'")
    check(same(reinforce.state_tensors(got), reinforce.state_tensors(st)),
          "graphed stage 1: Adam state or best differ from the eager "
          "epochs'")
    check(torch.equal(got.generator.get_state(), st.generator.get_state()),
          "graphed stage 1: the generator's state differs from the eager "
          "epochs'")
    out = {"epochs": epochs, "bit_equal": True,
           "graphed_s_with_capture": graphed_s, "eager_s": eager_s,
           "best_value": float(got.best_value)}
    log(f"[main] graph vs eager: {json.dumps(out)}")
    return out


def _service_requests(specs):
    from repro_torch import api

    ecfg = api.EnvConfig(objective="latency", constraint="area",
                         platform="iot", scenario="LP", dataflow=0,
                         levels=12)
    return [api.SearchRequest(workload=wl, env=ecfg, eps=eps, seed=seed,
                              method=method, options=dict(opts),
                              device="cuda")
            for method, wl, eps, seed, opts in specs]


def _same_outcome(a, b):
    return (a.best_value == b.best_value
            and a.history.tobytes() == b.history.tobytes()
            and a.pe.tobytes() == b.pe.tobytes()
            and a.kt.tobytes() == b.kt.tobytes()
            and a.df.tobytes() == b.df.tobytes())


class DispatchProbe:
    """Measures the search service's dispatches from outside, for one run.

    Used as a context manager around a service run.  It wraps, by name,
    ``CostEvalBatcher._dispatch`` and ``evaluate``,
    ``SearchService._run``, ``CostMemoCache.get_many`` and the batcher
    module's ``eval_point_rows`` and ``AGG_NAME``, its aggregation
    function; it adds no stats key.  For every dispatch it records the
    wall time (``time.perf_counter``) and the dispatcher thread's CPU
    time (``time.thread_time``): the gap is time off the CPU, waiting for
    the GIL or the scheduler (the CUDA runtime spins in a synchronize,
    which counts as CPU time).  It also records the time up to the cache
    lookup's return (the rows' concatenation, ``np.unique``, the keys and
    ``get_many``), the time in ``eval_point_rows`` and in the
    aggregation, the items, the fresh points (the per-row kernel's M),
    and its blocking host syncs: PyTorch's sync debug mode ("warn", for
    the whole run) turns each into a warning, which a filter counts on
    the dispatcher threads and drops.
    Every ``count_every``-th dispatch is also counted: a
    ``TorchFunctionMode`` on the dispatcher thread counts its torch calls
    (functions, methods, operators and indexing; property reads are left
    out), and the wall time spent in syncs is summed.  Counted dispatches
    run slower and are left out of the time means.  Each ``evaluate``
    call is a round trip of one search's batch; they are summed per
    method.
    """

    AGG_NAME = "aggregate_items"

    def __init__(self, count_every=16):
        self.count_every = count_every
        self.records = []
        self.round_trips = {}
        self._n = 0

    def __enter__(self):
        import threading
        import warnings

        import torch
        from torch.overrides import TorchFunctionMode

        from repro_torch.serving import batcher as bmod
        from repro_torch.serving import cost_cache, search_service

        probe, tl = self, threading.local()
        self._tl = tl
        self._patches = []

        def patch(owner, name, make):
            orig = getattr(owner, name)
            self._patches.append((owner, name, orig))
            setattr(owner, name, make(orig))

        def timed(key):
            def make(orig):
                def wrapper(*a, **k):
                    rec = getattr(tl, "rec", None)
                    t0 = time.perf_counter()
                    try:
                        return orig(*a, **k)
                    finally:
                        if rec is not None:
                            rec[key] += time.perf_counter() - t0
                            if key == "eval_s":
                                rec["fresh"] = len(a[0])
                return wrapper
            return make

        def lookup(orig):
            def wrapper(*a, **k):
                out = orig(*a, **k)
                rec = getattr(tl, "rec", None)
                if rec is not None and rec["lookup_s"] == 0.0:
                    rec["lookup_s"] = time.perf_counter() - rec["t0"]
                return out
            return wrapper

        class Calls(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                rec = tl.rec
                if getattr(func, "__name__", "") != "__get__":
                    rec["torch_calls"] += 1
                t0 = time.perf_counter()
                tl.synced = False
                out = func(*args, **(kwargs or {}))
                if tl.synced:
                    rec["sync_s"] += time.perf_counter() - t0
                return out

        def dispatch(orig):
            def wrapper(batcher, items):
                counted = probe._n % probe.count_every == 0
                probe._n += 1
                rec = {"items": len(items), "points": sum(
                    len(it.points) for it in items), "fresh": 0,
                    "counted": counted, "lookup_s": 0.0, "eval_s": 0.0,
                    "agg_s": 0.0, "torch_calls": 0, "syncs": 0,
                    "sync_s": 0.0, "t0": time.perf_counter()}
                tl.rec, tl.synced = rec, False
                mode = Calls() if counted else None
                if counted:
                    mode.__enter__()
                c0, t0 = time.thread_time(), time.perf_counter()
                try:
                    return orig(batcher, items)
                finally:
                    rec["wall_s"] = time.perf_counter() - t0
                    rec["cpu_s"] = time.thread_time() - c0
                    if counted:
                        mode.__exit__(None, None, None)
                    tl.rec = None
                    probe.records.append(rec)
            return wrapper

        def stream_sync(orig):
            def wrapper(stream):
                rec = getattr(tl, "rec", None)
                t0 = time.perf_counter()
                orig(stream)   # warns, and so is counted, in debug mode
                if rec is not None and rec["counted"]:
                    rec["sync_s"] += time.perf_counter() - t0
            return wrapper

        def run(orig):
            def wrapper(service, ticket):
                tl.method = ticket.request.method
                return orig(service, ticket)
            return wrapper

        def evaluate(orig):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    dt = time.perf_counter() - t0
                    rt = probe.round_trips.setdefault(
                        getattr(tl, "method", "?"), [0, 0.0])
                    rt[0] += 1
                    rt[1] += dt
            return wrapper

        def on_warning(orig):
            def wrapper(message, category, *a, **k):
                rec = getattr(tl, "rec", None)
                if "synchronizing CUDA operation" in str(message):
                    if rec is not None:
                        rec["syncs"] += 1
                        tl.synced = True
                    return None
                if "Synchronization debug mode" in str(message):
                    return None
                return orig(message, category, *a, **k)
            return wrapper

        B = bmod.CostEvalBatcher
        patch(B, "_dispatch", dispatch)
        patch(B, "evaluate", evaluate)
        patch(search_service.SearchService, "_run", run)
        patch(cost_cache.CostMemoCache, "get_many", lookup)
        patch(bmod, "eval_point_rows", timed("eval_s"))
        patch(bmod, self.AGG_NAME, timed("agg_s"))
        patch(torch.cuda.Stream, "synchronize", stream_sync)
        patch(warnings, "showwarning", on_warning)
        self._filters = warnings.filters[:]
        warnings.filterwarnings("always", message=".*synchroniz")
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        import warnings

        import torch

        torch.cuda.set_sync_debug_mode(0)
        for owner, name, orig in reversed(self._patches):
            setattr(owner, name, orig)
        warnings.filters[:] = self._filters
        return False

    def split(self, service_s):
        """The dispatches' means: ms each, the share of it off the CPU,
        the ms up to the cache lookup's return, in ``eval_point_rows``
        (over the dispatches with fresh points) and in the aggregation,
        items, torch calls and syncs (counted dispatches), the per-row
        kernel's M over its launches, and each method's round trips."""
        timed = [r for r in self.records if not r["counted"]]
        counted = [r for r in self.records if r["counted"]]
        fresh = [r for r in timed if r["fresh"]]
        mean = lambda rows, k: (sum(r[k] for r in rows) / len(rows)
                                if rows else None)
        ms = lambda rows, k: (None if not rows else 1e3 * mean(rows, k))
        wall = sum(r["wall_s"] for r in timed)
        cpu = sum(r["cpu_s"] for r in timed)
        out = {
            "dispatches": len(self.records), "timed": len(timed),
            "counted": len(counted),
            "ms_per_dispatch": ms(timed, "wall_s"),
            "cpu_ms_per_dispatch": ms(timed, "cpu_s"),
            "off_cpu_share": (wall - cpu) / wall if wall else None,
            "lookup_ms": ms(timed, "lookup_s"),
            "eval_ms_fresh_dispatches": ms(fresh, "eval_s"),
            "agg_ms": ms(timed, "agg_s"),
            "fresh_dispatch_share": len(fresh) / max(len(timed), 1),
            "items_per_dispatch": mean(self.records, "items"),
            "points_per_dispatch": mean(self.records, "points"),
            "torch_calls_per_dispatch": mean(counted, "torch_calls"),
            "syncs_per_dispatch": mean(self.records, "syncs"),
            "sync_ms_per_dispatch": ms(counted, "sync_s"),
            "max_syncs_in_a_dispatch": max(
                (r["syncs"] for r in self.records), default=None),
            "max_syncs_without_fresh": max(
                (r["syncs"] for r in self.records if not r["fresh"]),
                default=None),
            "dispatch_share_of_service": wall * len(self.records)
            / max(len(timed), 1) / service_s}
        m = sorted(r["fresh"] for r in self.records if r["fresh"])
        if m:
            out["fresh_points_per_launch"] = {
                "launches": len(m), "mean": sum(m) / len(m),
                "median": m[len(m) // 2], "p90": m[int(0.9 * len(m))],
                "max": m[-1], **{f"at_most_{t}": sum(x <= t for x in m)
                                 for t in (64, 128, 256, 1024)}}
        for method, (n, s) in sorted(self.round_trips.items()):
            out[f"round_trips_{method}"] = n
            out[f"round_trip_ms_{method}"] = 1e3 * s / n
            out[f"round_trip_share_of_service_{method}"] = s / service_s
        return out


def service_run(dev, requests, probe=None):
    """``requests`` submitted together to the search service on the card
    (``probe``, a :class:`DispatchProbe`, measures its dispatches if
    given): the outcomes, the tickets, the service's stats and its wall
    seconds."""
    import contextlib

    import torch

    from repro_torch.serving import SearchService, ServiceConfig

    with probe or contextlib.nullcontext():
        t0 = time.perf_counter()
        with SearchService(ServiceConfig(max_workers=8, window_ms=2.0,
                                         device="cuda")) as svc:
            tickets = [svc.submit(r) for r in requests]
            outs = [t.result() for t in tickets]
            stats = svc.stats()
        torch.cuda.synchronize()
        return outs, tickets, stats, time.perf_counter() - t0


def phase_service(dev, specs=SERVICE_REQUESTS):
    """The search service against serial runs of the same requests; then
    the same requests again under :class:`DispatchProbe`, for the
    dispatch split.  Returns the launches, the timings and the serial
    outcomes (phase 7b's yardstick)."""
    import torch

    from repro_torch import api
    from repro_torch.kernels import ops, ref

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    serial = [api.run_search(r) for r in _service_requests(specs)]
    torch.cuda.synchronize()
    serial_s = time.perf_counter() - t0

    ops.reset_launch_counts()
    outs, tickets, stats, service_s = service_run(
        dev, _service_requests(specs))
    counts = ops.launch_counts()
    plain_on_card = dict(ref.cuda_calls)

    for spec, got, want in zip(specs, outs, serial):
        check(_same_outcome(got, want),
              f"service outcome of {spec[:4]} differs from its serial run: "
              f"{got.best_value} vs {want.best_value}")
        check(len(got.history) == spec[2], f"{spec[:4]}: history length")
    dispatches = stats["dispatches"]
    check(stats["fused_dispatches"] > 0, "the batcher fused no dispatch")
    check(stats["cache_hit_rate"] > 0, "the memo cache had no hit")
    check(1 <= counts["cost_eval_multi"] <= dispatches,
          f"per-row kernel launched {counts['cost_eval_multi']} times in "
          f"{dispatches} dispatches")
    check(counts["lstm_cell"] > 0 and counts["cost_eval"] > 0,
          f"the reinforce request did not run the kernels: {counts}")
    check(all(v == 0 for v in plain_on_card.values()),
          f"a plain version ran on the card: {plain_on_card}")
    for spec, out, t in zip(specs, outs, tickets):
        log(json.dumps({"service": spec[0], "workload": spec[1],
                        "eps": spec[2], "best_value": out.best_value,
                        "feasible": out.feasible,
                        "wall_seconds": t.wall_seconds}))

    # The dispatch split, from a second run under the probe (its times
    # are instrumented, so they compare only with other probed runs).
    probe = DispatchProbe()
    probed, _, probed_stats, probed_s = service_run(
        dev, _service_requests(specs), probe)
    split = probe.split(probed_s)
    check(all(_same_outcome(a, b) for a, b in zip(probed, serial)),
          "a probed service outcome differs from its serial run")
    check(split["dispatches"] == probed_stats["dispatches"],
          f"the probe saw {split['dispatches']} of "
          f"{probed_stats['dispatches']} dispatches")
    check(split["max_syncs_in_a_dispatch"] <= 2
          and (split["max_syncs_without_fresh"] or 0) <= 1,
          f"a dispatch synced the host more than twice, or more than once "
          f"without fresh points: {split}")
    timing = {
        "requests": len(specs), "serial_s": serial_s,
        "service_s": service_s,
        "searches_per_sec": len(specs) / service_s,
        "cache_hit_rate": stats["cache_hit_rate"],
        "points": stats["points"], "unique_points": stats["unique_points"],
        "fresh_points": stats["fresh_points"],
        "points_eliminated_frac": 1.0 - stats["fresh_points"]
        / max(stats["points"], 1),
        "dispatches": dispatches,
        "fused_dispatches": stats["fused_dispatches"],
        "items_per_dispatch": stats["items"] / max(dispatches, 1),
        "max_items_per_dispatch": stats["max_items_per_dispatch"],
        "ms_per_dispatch": 1e3 * stats["dispatch_seconds"]
        / max(dispatches, 1),
        "probed_service_s": probed_s, "dispatch_split": split}
    log(f"[service] byte-identical to serial on {len(specs)} requests; "
        f"launches {json.dumps(counts)}; plain versions on the card "
        f"{json.dumps(plain_on_card)}; {json.dumps(timing)}")
    log(f"[service] dispatch split (probed run, {probed_s:.3f} s): "
        f"{split['ms_per_dispatch']:.3f} ms per dispatch, "
        f"{100 * split['off_cpu_share']:.1f}% of it off the CPU, "
        f"{split['syncs_per_dispatch']:.2f} syncs and "
        f"{split['torch_calls_per_dispatch']:.1f} torch calls per dispatch; "
        f"sa round trip {split.get('round_trip_ms_sa', 0):.3f} ms; "
        f"unprobed: serial {serial_s:.3f} s, service {service_s:.3f} s")
    return counts, timing, serial


def _telemetry_request(method):
    """Phase 7b (a)'s request of ``method`` (``TELEMETRY_RUNS``) on
    mobilenet_v2 at full width (LSTM(128), L = 12, latency / area / dla,
    LP, seed 0)."""
    from repro_torch import api
    from repro_torch.costmodel import workloads
    from repro_torch.distributed import collectives

    eps, opts, platform = TELEMETRY_RUNS[method]
    opts = dict(opts)
    if "mesh" in opts:
        opts["mesh"] = collectives.VirtualMesh(*opts["mesh"], "cuda")
    return api.SearchRequest(
        workload=workloads.get_workload("mobilenet_v2"),
        env=api.EnvConfig(objective="latency", constraint="area",
                          platform=platform, dataflow=0, levels=12),
        eps=eps, seed=0, method=method, options=opts, device="cuda")


def _telemetry_launches(method, N=53):
    """The launches phase 7b (a)'s run of ``method`` implies: make_env
    scores C_max once (one table launch) and the engine the rest.  For
    reinforce and two_stage the LSTM forward is a lower bound (checked as
    phase 6 does) and the backward equals it."""
    eps, opts, _ = TELEMETRY_RUNS[method]
    ceil = lambda a, b: -(-a // b)
    if method in ("random", "grid"):
        return {"cost_eval": 1 + ceil(eps, 512)}
    if method == "bo":      # 64 random draws, then batches of 16
        return {"cost_eval": 1 + 1 + ceil(eps - 64, 16)}
    if method == "sa":      # the initial genome, then one a step
        return {"cost_eval": 1 + 1 + eps}
    if method == "ga":
        return {"cost_eval": 1 + eps // opts["population"]}
    if method == "nsga2":   # one per-row launch a generation
        return {"cost_eval": 1, "cost_eval_multi": eps // opts["population"]}
    if method == "relaxed":
        return {"cost_eval": 1 + eps}
    if method in ("a2c", "ppo2"):
        E = opts["episodes_per_epoch"]
        epochs, updates = eps // E, 1 if method == "a2c" else 4
        return {"cost_eval": 1 + N * epochs,
                "lstm_cell": N * (1 + updates) * epochs,
                "lstm_cell_bwd": N * updates * epochs}
    if method == "fanout":
        return _fanout_launches(opts["inner"], eps, {}, opts["n_shards"])
    if method == "dist_reinforce":
        shape, axes = opts["mesh"]
        return _dist_launches(eps, shape, axes, opts["episodes_per_device"],
                              opts["compress_pod_axis"], N)
    gens = opts["ga"]["generations"] if method == "two_stage" else 0
    return {"cost_eval": 1 + N * eps + gens, "lstm_cell": N * eps}


def _dist_launches(eps, shape, axes, E, compress, N=53, make_env=True):
    """The launches a dist_reinforce run of ``eps`` samples on a virtual
    mesh implies: per epoch N table-cost and N LSTM-forward launches at B
    = n x E, and N LSTM-backward launches a backward pass (one pass; one a
    pod with the int8 hop); make_env's one table launch."""
    n = math.prod(shape)
    epochs = max(eps // (E * n), 1)
    passes = shape[axes.index("pod")] if compress and "pod" in axes else 1
    return {"cost_eval": int(make_env) + N * epochs,
            "lstm_cell": N * epochs, "lstm_cell_bwd": passes * N * epochs}


# Methods whose runs replay stage 1's graph: their LSTM forward count is
# a lower bound (checked as phase 6 does), the backward as often.
STAGE1_METHODS = ("reinforce", "two_stage", "fanout")


def _check_run_launches(what, method, counts, plain_on_card, want):
    """``_check_launches`` for a run of ``method``; for
    ``STAGE1_METHODS`` ``want["lstm_cell"]`` is a lower bound and the
    backward must launch as often as the forward."""
    if method not in STAGE1_METHODS:
        _check_launches(what, counts, plain_on_card, want)
        return
    check(counts["cost_eval"] == want["cost_eval"]
          and counts["lstm_cell"] >= want["lstm_cell"]
          and counts["lstm_cell_bwd"] == counts["lstm_cell"]
          and all(n == 0 for k, n in counts.items() if k not in (
              "cost_eval", "lstm_cell", "lstm_cell_bwd")),
          f"{what}: launches {counts}, the run implies {want} (the "
          f"LSTM forward at least, the backward as often)")
    check(all(v == 0 for v in plain_on_card.values()),
          f"{what}: a plain version ran on the card: {plain_on_card}")


def _same_frontier(a, b):
    if a.frontier is None or b.frontier is None:
        return a.frontier is None and b.frontier is None
    return (set(a.frontier) == set(b.frontier)
            and all(a.frontier[k].tobytes() == b.frontier[k].tobytes()
                    for k in a.frontier))


def telemetry_observational(dev):
    """Phase 7b (a): each registered method twice through
    ``api.run_search``, telemetry off then on, each run counted: the
    outcomes byte-identical, the launches exact and equal, the flight
    recorder naming the method with the hard evaluations the run implies;
    then phase 6's 20 graphed epochs against 20 eager ones with telemetry
    on."""
    from repro_torch import api, obs

    check(sorted(TELEMETRY_RUNS) == sorted(api.list_optimizers()),
          f"phase 7b runs {sorted(TELEMETRY_RUNS)}, the port registers "
          f"{sorted(api.list_optimizers())}")
    counts, timing = {}, {}
    for method in TELEMETRY_RUNS:
        off, off_s, c_off, plain_off = _counted(
            lambda: api.run_search(_telemetry_request(method)))
        obs.reset()
        obs.enable(trace=True)
        try:
            on, on_s, c_on, plain_on = _counted(
                lambda: api.run_search(_telemetry_request(method)))
        finally:
            obs.disable()
        _check_run_launches(method, method, c_off, plain_off,
                            _telemetry_launches(method))
        check(c_on == c_off and plain_on == plain_off,
              f"{method}: launches with telemetry on {c_on} differ from "
              f"off {c_off} (plain versions on the card {plain_on})")
        check(_same_outcome(on, off) and _same_frontier(on, off)
              and off.telemetry is None,
              f"{method}: telemetry changed the outcome: {on.best_value} vs "
              f"{off.best_value}")
        check(method not in TELEMETRY_FEASIBLE or off.feasible,
              f"{method}: no feasible point, so telemetry on / off compares "
              "infeasible traces only")
        t = on.telemetry
        eps, opts, _ = TELEMETRY_RUNS[method]
        # The fanout's device backend accounts each epoch as E x n_shards
        # hard evaluations (engine "dist_reinforce").
        want_evals = (eps + (opts["ga"]["population"]
                             * opts["ga"]["generations"]
                             if method == "two_stage" else 0)) * (
            opts["n_shards"] if method == "fanout" else 1)
        check(t is not None and t["engine"] == method
              and t.get("hard_evals") == want_evals,
              f"{method}: telemetry {t}, the run implies {want_evals} hard "
              f"evaluations")
        spans = obs.tracer().spans()
        counts[method] = c_on
        timing[method] = {
            "eps": eps, "off_s": off_s, "on_s": on_s,
            "best_value": on.best_value, "hard_evals": t["hard_evals"],
            "chunks": t.get("chunks"), "spans": len(spans),
            "jit_compiles": t.get("jit_compiles", 0)}
        log(f"[http] telemetry on/off {method}: byte-identical, launches "
            f"{json.dumps(c_on)}; {json.dumps(timing[method])}")
    obs.reset()
    obs.enable(trace=True)
    try:
        timing["graph_vs_eager"] = stage1_graph_vs_eager(
            dev, GRAPH_CHECK_EPOCHS)
    finally:
        obs.disable()
    return counts, timing


def _http_body(spec, tenant):
    """One of ``SERVICE_REQUESTS`` as the front door's JSON body."""
    method, wl, eps, seed, opts = spec
    return {"workload": wl, "method": method, "eps": eps, "seed": seed,
            "objective": "latency", "constraint": "area", "platform": "iot",
            "scenario": "LP", "dataflow": "dla", "tenant": tenant, **opts}


def _wire_equal(d, out):
    """A result over the wire against an in-process outcome, bit for bit:
    best value, history, assignment and the frontier."""
    import numpy as np

    same = lambda got, want: np.asarray(
        got, np.asarray(want).dtype).tobytes() == np.asarray(want).tobytes()
    ok = d["best_value"] == out.best_value and all(
        same(d[k], getattr(out, k)) for k in ("history", "pe", "kt", "df"))
    if out.frontier is not None:
        ok = ok and set(d.get("frontier", ())) == set(out.frontier) and all(
            same(d["frontier"][k], v) for k, v in out.frontier.items())
    return ok


def _load_checker():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_telemetry", ROOT / "tools" / "check_telemetry.py")
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    return checker


def front_door(dev, serial, service):
    """Phase 7b (b): ``SERVICE_REQUESTS`` and phase 6c's nsga2 request
    through ``SearchHTTPService`` on an ephemeral port with telemetry on,
    under two tenants weighted 2:1, one request's progress streamed; each
    result over the wire equal to its serial run (``serial``, phase 7's),
    the per-tenant stats adding up, ``/metrics`` passing
    ``tools/check_telemetry.py``, the launches counted."""
    import tempfile

    import torch

    from repro_torch import api, obs
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import ops, ref
    from repro_torch.obs import instrument
    from repro_torch.serving import (HttpConfig, SearchClient,
                                     SearchHTTPService, ServiceConfig)

    wl = workloads.get_workload("mobilenet_v2")
    nsga2 = api.run_search(_nsga2_request(wl, SERVICE_NSGA2_EPS))
    bodies = [_http_body(spec, tenant)
              for spec, tenant in zip(SERVICE_REQUESTS, HTTP_TENANTS)]
    bodies.append(_http_body(
        ("nsga2", "mobilenet_v2", SERVICE_NSGA2_EPS, 0,
         {"population": NSGA2_POPULATION, "archive": NSGA2_ARCHIVE}),
        HTTP_TENANTS[-1]))
    want = list(serial) + [nsga2]

    obs.reset()
    obs.enable(trace=True)
    try:
        hub = SearchHTTPService(
            service_cfg=ServiceConfig(max_workers=8, window_ms=2.0,
                                      device="cuda"),
            http_cfg=HttpConfig(port=0, tenant_weights=HTTP_TENANT_WEIGHTS,
                                progress_poll_s=0.01)).start()
        try:
            client = SearchClient(port=hub.port, timeout=HTTP_TIMEOUT_S)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            uids = [client.submit(b)["uid"] for b in bodies]
            stream = list(client.progress(uids[HTTP_STREAMED]))
            results = [client.result(u, timeout=HTTP_TIMEOUT_S)
                       for u in uids]
            torch.cuda.synchronize()
            http_s = time.perf_counter() - t0
            counts = ops.launch_counts()
            plain_on_card = dict(ref.cuda_calls)
            stats = client.stats()
            text = client.metrics_text()
        finally:
            hub.close()
        kernel = instrument.DISPATCH_SECONDS.stats(program="cost_eval_kernel")
        compiles = instrument.JIT_COMPILES.value(program="cost_eval_kernel")
        plain_spans = instrument.DISPATCH_SECONDS.stats(
            program="cost_eval_torch")["count"]
    finally:
        obs.disable()

    for body, got, out in zip(bodies, results, want):
        check(_wire_equal(got, out),
              f"{body['method']} over HTTP differs from its serial run: "
              f"{got['best_value']} vs {out.best_value}")
        check(got["telemetry"]["engine"] == body["method"],
              f"{body['method']} over HTTP: telemetry {got['telemetry']}")
    trials, last = stream[:-1], stream[-1]
    streamed_eps = bodies[HTTP_STREAMED]["eps"]
    steps = [r["step"] for r in trials]
    check(last == {"status": "done", "done": True} and len(trials) > 1
          and steps == sorted(steps) and steps[-1] == streamed_eps
          and min(r["best_value"] for r in trials)
          == results[HTTP_STREAMED]["best_value"],
          f"the progress stream of {bodies[HTTP_STREAMED]['method']}: "
          f"{stream[:3]} ... {stream[-2:]}")
    tenants = stats["front_door"]["tenants"]
    for name, weight in HTTP_TENANT_WEIGHTS:
        e = tenants[name]
        mine = [b for b in bodies if b["tenant"] == name]
        check(e["submitted"] == e["completed"] == len(mine)
              and e["eps_finished"] == e["eps_requested"]
              == sum(b["eps"] for b in mine) and e["weight"] == weight
              and e["rejected"] == e["failed"] == e["cancelled"] == 0,
              f"tenant {name}: {e}")
    check(stats["service"]["completed"] == len(bodies),
          f"the service completed {stats['service']['completed']} of "
          f"{len(bodies)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "metrics.prom"
        path.write_text(text)
        samples = _load_checker().check_metrics(str(path), [
            "repro_http_requests", "repro_service_requests",
            "repro_batcher_dispatches", "repro_dispatch_seconds",
            "repro_search_hard_evals"])
    dispatches = stats["service"]["dispatches"]
    check(1 <= counts["cost_eval_multi"] <= dispatches
          and kernel["count"] == counts["cost_eval_multi"]
          and plain_spans == 0,
          f"over HTTP: per-row kernel launched {counts['cost_eval_multi']} "
          f"times in {dispatches} dispatches, {kernel['count']} dispatch "
          f"spans, {plain_spans} plain spans")
    check(all(v == 0 for v in plain_on_card.values()),
          f"over HTTP: a plain version ran on the card: {plain_on_card}")
    timing = {
        "requests": len(bodies), "http_s": http_s,
        "service_s": service["service_s"], "serial_s": service["serial_s"],
        "dispatches": dispatches,
        "cache_hit_rate": stats["service"]["cache_hit_rate"],
        "streamed_trials": len(trials), "metrics_samples": samples,
        "cost_eval_kernel_dispatches": kernel["count"],
        "cost_eval_kernel_compiles": compiles,
        "cost_eval_kernel_mean_dispatch_ms": 1e3 * kernel["mean"],
        "cost_eval_kernel_max_dispatch_ms": 1e3 * kernel["max"],
        "tenants": tenants}
    log(f"[http] {len(bodies)} requests over HTTP byte-identical to serial, "
        f"frontier included: {http_s:.3f} s (in-process service "
        f"{service['service_s']:.3f} s, serial {service['serial_s']:.3f} s "
        f"in phase 7); cost_eval_kernel {kernel['count']} dispatches, "
        f"{compiles:.0f} compiles, {1e3 * kernel['mean']:.3f} ms mean "
        f"dispatch; launches {json.dumps(counts)}; {json.dumps(timing)}")
    return counts, timing


def telemetry_cost(dev, serial, service):
    """Phase 7b (c): phase 7's service mix once more with telemetry on,
    under ``DispatchProbe``: the outcomes equal the serial runs, each with
    its flight-recorder summary, and no dispatch syncs the host more than
    phase 7 allows.  Its wall seconds are a record beside phase 7's
    probed and unprobed runs with telemetry off."""
    from repro_torch import obs

    obs.reset()
    obs.enable(trace=True)
    try:
        probe = DispatchProbe()
        outs, _, stats, probed_s = service_run(
            dev, _service_requests(SERVICE_REQUESTS), probe)
    finally:
        obs.disable()
    split = probe.split(probed_s)
    for spec, got, want in zip(SERVICE_REQUESTS, outs, serial):
        check(_same_outcome(got, want),
              f"service outcome of {spec[:4]} with telemetry on differs "
              f"from its serial run")
        check(got.telemetry is not None and got.telemetry["engine"]
              == spec[0], f"{spec[:4]}: telemetry {got.telemetry}")
    check(split["dispatches"] == stats["dispatches"],
          f"the probe saw {split['dispatches']} of {stats['dispatches']} "
          f"dispatches")
    check(split["max_syncs_in_a_dispatch"] <= 2
          and (split["max_syncs_without_fresh"] or 0) <= 1,
          f"with telemetry on a dispatch synced the host more than twice, "
          f"or more than once without fresh points: {split}")
    off = service["dispatch_split"]
    timing = {"probed_on_s": probed_s,
              "probed_off_s": service["probed_service_s"],
              "unprobed_off_s": service["service_s"],
              "on_over_probed_off": probed_s / service["probed_service_s"],
              "ms_per_dispatch_on": split["ms_per_dispatch"],
              "ms_per_dispatch_off": off["ms_per_dispatch"],
              "dispatches": split["dispatches"],
              "max_syncs_in_a_dispatch": split["max_syncs_in_a_dispatch"],
              "syncs_per_dispatch": split["syncs_per_dispatch"]}
    log(f"[http] telemetry cost (a record, not a gate): the service mix "
        f"probed with telemetry on {probed_s:.3f} s against "
        f"{service['probed_service_s']:.3f} s probed and "
        f"{service['service_s']:.3f} s unprobed with it off (phase 7); "
        f"{json.dumps(timing)}")
    return timing


def phase_http(dev, serial, service):
    """Phase 7b: the HTTP front door and telemetry (a), (b), (c)."""
    counts, timing = telemetry_observational(dev)
    http_counts, timing["front_door"] = front_door(dev, serial, service)
    counts["http"] = http_counts
    timing["cost"] = telemetry_cost(dev, serial, service)
    return counts, timing


def _greedy(model, cfg, first, steps, dev, feats=None):
    """``steps`` greedy decode steps from the tokens ``first``: the tokens
    and the logits of every step.  Audio and vlm models attend to the
    frontend features ``feats`` (1, S, d)."""
    import torch

    from repro_torch.models import lm

    cache = lm.init_cache(cfg, first.shape[0], steps, device=dev)
    if feats is not None:
        k, v = lm.precompute_cross_kv(
            model, cfg, feats.expand(first.shape[0], *feats.shape[1:]))
        cache = cache._replace(cross_k=k, cross_v=v)
    tok, toks, logits = first, [], []
    for _ in range(steps):
        out, cache = lm.decode_step(model, cfg, cache, tok)
        tok = torch.argmax(out, dim=-1)
        toks.append(tok)
        logits.append(out)
    return torch.stack(toks), torch.stack(logits)


def _step_bound(model, cfg, B, T, moe_rows=None):
    """The least time (ms) and its limit for one decode step of B tokens
    at cache position T, and the step's bytes.

    Bytes: each weight the step reads, once: of the token embedding its B
    rows, unless the unembedding is tied to it and reads it whole; not the
    audio encoder, which decode does not run, nor the cross-attention's
    wk / wv, which made the cross K/V; of an MoE layer's experts only those
    the step routed to (``moe_rows``: per MoE layer, (experts routed,
    kept rows)).  Then the self-attention caches' T + 1 rows (the new one
    written), every cross K/V row, the float32 Mamba states and conv
    tails read and written, and the logits.  Operations: 2 per weight
    element and row of each matrix product (hybrid's shared block at each
    of its sites), 4 per key, head and head dim of each attention, at the
    bf16 tensor-core rate."""
    from repro_torch.models import lm, ssm

    el = model.embed.tok.element_size()
    nbytes = ops = 0
    for name, p in model.named_parameters():
        parts = name.split(".")
        size = p.numel() * p.element_size()
        if parts[0] in ("encoder", "enc_norm") or (
                parts[-2] == "xattn" and parts[-1] in ("wk", "wv")):
            continue
        if name == "embed.tok":
            if cfg.tie_embeddings:
                nbytes += size
                ops += 2 * B * p.numel()
            else:
                nbytes += B * cfg.d_model * el
            continue
        if parts[-2] == "moe" and parts[-1] != "router":
            experts, rows = moe_rows[int(parts[1])]
            nbytes += size * experts / cfg.num_experts
            ops += 2 * rows * p.numel() / cfg.num_experts
            continue
        nbytes += size
        if p.dim() == 2 and parts[-1] != "conv_w":
            sites = lm.attention_sites(cfg) if parts[0] == "shared_attn" else 1
            ops += 2 * B * p.numel() * sites
    sites, xsites = lm.attention_sites(cfg), lm.cross_sites(cfg)
    S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
    kv_row = 2 * B * cfg.num_kv_heads * cfg.hd() * el     # a K and a V row
    nbytes += kv_row * (sites * (T + 1) + xsites * S)
    ops += 4 * B * cfg.num_heads * cfg.hd() * (sites * (T + 1) + xsites * S)
    if lm.mamba_layers(cfg):
        d_inner, H, P, N = ssm.dims(cfg)
        state = 4 * B * (H * P * N + (ssm.CONV_WIDTH - 1) * (d_inner + 2 * N))
        nbytes += 2 * state * lm.mamba_layers(cfg)
        ops += 5 * B * H * P * N * lm.mamba_layers(cfg)
    nbytes += B * cfg.vocab_size * el
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def _device_busy(fn, steps, top=3):
    """Device time per call of ``fn`` from a profiler trace of ``steps``
    calls, the wall time per call, the ``top`` kernels that took most, and
    the flash-decode kernels' device time and launches per call (split and
    combine together); None where the trace shows no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) == torch.autograd
              .DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        return None
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    flash = [e for e in events if "flash_decode" in e.key]
    return {"device_ms_per_step": device_us / 1e3 / steps,
            "flash_decode_device_ms_per_step": sum(
                e.self_device_time_total for e in flash) / 1e3 / steps,
            "flash_decode_kernels_per_step": sum(e.count for e in flash)
            / steps,
            "wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_share": device_us / 1e6 / wall,
            "top_kernels": [[e.key[:60], e.self_device_time_total / 1e3
                             / steps, e.count // steps] for e in top]}


TRACE_TRIES = 4


def _span_union(spans):
    """The length of the union of sorted (start, end) intervals."""
    union, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            union += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return union + hi - lo


def _device_spans(prof):
    """The sorted (start, end) µs of a profiler trace's device events."""
    import torch

    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if getattr(e, "device_type", None)
                  == torch.autograd.DeviceType.CUDA)


def _kernel_trace(fn, calls):
    """A profiler trace of ``calls`` back-to-back calls of ``fn``: wall and
    device time per call, the device's busy share of the (profiled) wall
    time (device time summed, and the union of the device intervals, which
    overlapping streams would make smaller), device events (kernels,
    copies, fills) per call, and each
    kernel's device µs and launches per call by name, largest first; None
    where the trace shows no device time.  A trace that comes back without
    device events is taken again, up to ``TRACE_TRIES`` times in all: the
    profiler has returned such traces for short runs of 40 launches on a
    card, once twice in a row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_type", None) == torch.autograd
                  .DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in events)
        if device_us > 0:
            break
    else:
        return None
    rows = sorted(events, key=lambda e: -e.self_device_time_total)
    return {"calls": calls, "wall_ms_per_call": 1e3 * wall / calls,
            "device_us_per_call": device_us / calls,
            "device_busy_share": device_us / 1e6 / wall,
            "device_busy_share_union": (_span_union(_device_spans(prof))
                                        / 1e6 / wall),
            "launches_per_call": sum(e.count for e in events) / calls,
            "kernels": [[e.key[:90], e.self_device_time_total / calls,
                         e.count / calls] for e in rows]}


def _per_launch_us(trace, name):
    """Device µs per launch of the kernels whose name holds ``name`` in a
    :func:`_kernel_trace`, and their launches per call; (None, 0) if none
    ran."""
    rows = [r for r in trace["kernels"] if name in r[0]]
    n = sum(r[2] for r in rows)
    return (sum(r[1] for r in rows) / n if n else None), n


# Kernel names in a trace (the backward's two kernels,
# lstm_cell_bwd_kernel and lstm_cell_bwd_untiled_kernel, both hold the
# last), and the search path's timed calls.
COST_KERNEL, LSTM_KERNEL, LSTM_BWD_KERNEL = ("cost_eval_kernel",
                                             "lstm_cell_kernel",
                                             "lstm_cell_bwd")
SEARCH_TRACE_CALLS = 200


def search_kernel_calls(dev):
    """The search path's kernel calls at its shapes, through the wrappers
    that every tree of the port has: name -> (fn, kernel name, CUDA-event
    iterations).  ``cost_eval 1x1`` is the rollout's per-step call (E = 1,
    one layer's row); ``cost_eval 20x53`` the kernel's wrapper on
    contiguous (B, N) inputs, the shape of PERF.md's kernel table;
    ``table_cost 20x53`` a local-GA generation's call ((P, N) genomes, the
    frozen (N,) dataflow row); the LSTM forward's wrapper at (1, 10, 128)
    (h', c' and the saved gates, as stage 1 calls it), the step under
    autograd, its backward's wrapper on those saved gates, and the
    backward under autograd (``torch.autograd.grad`` over a kept
    graph)."""
    import torch

    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, lstm_cell, ops

    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    pts = lambda hi, B, n: torch.randint(1, hi, (B, n), generator=gen,
                                         device=dev).to(torch.float32)
    row = torch.as_tensor(arr[17], dtype=torch.float32,
                          device=dev)[:, None]
    pe1, kt1, df1 = pts(161, 1, 1), pts(17, 1, 1), torch.zeros((1, 1),
                                                              device=dev)
    lt = _layers_table(arr, dev)
    pe, kt = pts(161, 20, N), pts(17, 20, N)
    df = torch.zeros((20, N), device=dev)
    df_row = torch.zeros((N,), device=dev)
    x, h, c, wx, wh, b = _lstm_inputs(1, 10, 128, dev, seed=7)
    leaves = [a.clone().requires_grad_() for a in (x, h, c, wx, wh, b)]
    outs = ops.lstm_step(*leaves)
    up = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    gates = lstm_cell.lstm_cell(x, h, c, wx, wh, b)[2:]
    return {
        "cost_eval 1x1": (lambda: ops.table_cost(row, pe1, kt1, df1),
                          COST_KERNEL, 2000),
        "cost_eval 20x53": (lambda: costmodel_eval.cost_eval(lt, pe, kt, df),
                            COST_KERNEL, 2000),
        "table_cost 20x53": (lambda: ops.table_cost(lt, pe, kt, df_row),
                             COST_KERNEL, 2000),
        "lstm_cell 1x10x128": (lambda: lstm_cell.lstm_cell(x, h, c, wx, wh,
                                                           b),
                               LSTM_KERNEL, 2000),
        "lstm_step autograd 1x10x128": (lambda: ops.lstm_step(*leaves),
                                        LSTM_KERNEL, 2000),
        "lstm_cell_bwd wrapper 1x10x128": (lambda: lstm_cell.lstm_cell_bwd(
            x, h, c, wx, wh, gates, *up), LSTM_BWD_KERNEL, 2000),
        "lstm_cell_bwd 1x10x128": (lambda: torch.autograd.grad(
            outs, leaves, up, retain_graph=True), LSTM_BWD_KERNEL, 500),
    }


def search_kernel_times(dev, calls=SEARCH_TRACE_CALLS):
    """:func:`search_kernel_calls` timed: CUDA-event ms per call, and from
    a profiler trace of ``calls`` calls the device µs and device events per
    call, and the named kernel's device µs per launch (None where the tree
    has no such kernel)."""
    out = {}
    for name, (fn, kernel, iters) in search_kernel_calls(dev).items():
        ms = time_ms(fn, iters)
        trace = _kernel_trace(fn, calls)
        check(trace is not None, f"the profiler trace of {name} shows no "
              "device time")
        us, n = _per_launch_us(trace, kernel)
        out[name] = {"ms": ms, "device_us_per_call":
                     trace["device_us_per_call"],
                     "launches_per_call": trace["launches_per_call"],
                     "kernel_device_us_per_launch": us,
                     "kernel_launches_per_call": n,
                     "kernels": trace["kernels"][:4]}
    return out


def stage1_epoch_calls(dev):
    """Phase 6's stage-1 epoch as this tree of the port runs it: ``eager``
    (``make_epoch_fn``) and, where the tree has ``EpochRunner``,
    ``graphed`` (one replay of its captured epoch), each on its own state;
    and the eager state's box, for the local GA that follows it."""
    from repro_torch.core import reinforce
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1_setup(dev)
    opt = optim.Adam(lr=rcfg.lr)
    st = [reinforce.init_search(env, ecfg, pcfg, rcfg, opt)]
    epoch_fn = reinforce.make_epoch_fn(ecfg, pcfg, rcfg, env, opt)

    def eager():
        st[0], _ = epoch_fn(st[0])

    calls = {"eager": eager}
    if hasattr(reinforce, "EpochRunner"):
        runner = reinforce.EpochRunner(
            reinforce.init_search(env, ecfg, pcfg, rcfg, opt),
            reinforce.make_inplace_epoch_fn(ecfg, pcfg, rcfg, env, opt), 1)
        calls["graphed"] = runner.step
    return calls, (env, ecfg, st)


def search_traces(dev, graphed=GRAPHED_TRACE_EPOCHS, generations=20):
    """Phase 6's traces: one eager stage-1 epoch, ``graphed`` replays of
    the captured epoch, and ``generations`` local-GA generations
    (population 20) from the eager epochs' best, each after a warm-up:
    unprofiled ms per epoch / generation, and from a profiler trace the
    device's busy share of it, device events per epoch / generation, and
    device time by kernel."""
    from repro_torch.core import ga as ga_lib
    from repro_torch.core import reinforce

    calls, (env, ecfg, st) = stage1_epoch_calls(dev)
    pe, kt, df = reinforce.solution_arrays(st[0], env)
    engine = ga_lib.make_local_ga_engine(env, ecfg, pe, kt, df,
                                         ga_lib.LocalGAConfig())
    gs = [engine.init_carry(0)]

    def generation():
        gs[0], _ = engine.evolve(gs[0], engine.fitness(gs[0].pop))

    out = {}
    for name, fn, n in (("stage1_epoch_eager", calls["eager"], 1),
                        ("stage1_epoch_graphed", calls["graphed"], graphed),
                        ("local_ga_generation", generation, generations)):
        for _ in range(2):
            fn()
        ms = time_ms(fn, n, warmup=0)
        trace = _kernel_trace(fn, n)
        check(trace is not None, f"the profiler trace of {name} shows no "
              "device time")
        trace["unprofiled_ms"] = ms
        trace["device_busy_share_unprofiled"] = (
            trace["device_us_per_call"] / 1e3 / ms)
        out[name] = trace
    return out


def _engine_requests():
    """Phase 6b's requests on mobilenet_v2 at full width (LSTM(128), L =
    12, latency / area / dla, LP, seed 0): a2c and ppo2 under the cloud
    budget, relaxed under iot.  Under iot a2c and ppo2 find no feasible
    point in 400 samples (nor do the JAX package's, seed 0), so their runs
    there would check no outcome."""
    from repro_torch import api
    from repro_torch.costmodel import workloads

    wl = workloads.get_workload("mobilenet_v2")
    mk = lambda method, eps, platform, opts: api.SearchRequest(
        workload=wl, env=api.EnvConfig(
            objective="latency", constraint="area", platform=platform,
            dataflow=0, levels=12),
        eps=eps, seed=0, method=method, options=dict(opts), device="cuda")
    ac = {"episodes_per_epoch": AC_EPISODES}
    return wl, {"a2c": mk("a2c", AC_EPS, "cloud", ac),
                "ppo2": mk("ppo2", AC_EPS, "cloud", ac),
                "relaxed": mk("relaxed", RELAXED_EPS, "iot", {})}


def _counted(fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after: (result, seconds, launches, plain versions on the card)."""
    import torch

    from repro_torch.kernels import ops, ref

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, ops.launch_counts(),
            dict(ref.cuda_calls))


def _check_launches(what, counts, plain_on_card, want):
    """Each kernel launched exactly as ``want`` says (0 where it does not
    name it), and no plain version ran on the card."""
    for kernel, n in counts.items():
        check(n == want.get(kernel, 0),
              f"{what}: {kernel} launched {n} times, the run implies "
              f"{want.get(kernel, 0)}")
    check(all(v == 0 for v in plain_on_card.values()),
          f"{what}: a plain version ran on the card: {plain_on_card}")


def phase_engines(dev):
    """Phase 6b: a2c, ppo2 and relaxed through ``api.run_search`` on the
    card, each run counted and its outcome checked; one relaxed request
    through the search service against its serial run; then a profiler
    trace of a short run of each engine."""
    import dataclasses

    from repro_torch import api

    N = 53

    def want(method, eps):
        # Per epoch: one cost launch at (E, 1) and one LSTM forward a
        # rollout step; eval_sequence's forward and its backward once a
        # step per update (a2c one update, ppo2 ppo_updates = 4).
        # make_env scores C_max once; relaxed adds one cost launch a
        # hard probe.
        epochs, updates = eps // AC_EPISODES, 1 if method == "a2c" else 4
        if method == "relaxed":
            return {"cost_eval": 1 + eps}
        return {"cost_eval": 1 + N * epochs,
                "lstm_cell": N * (1 + updates) * epochs,
                "lstm_cell_bwd": N * updates * epochs}

    wl, reqs = _engine_requests()
    counts, timing = {}, {}
    for method, req in reqs.items():
        out, secs, c, plain = _counted(lambda: api.run_search(req))
        _check_launches(method, c, plain, want(method, req.eps))
        _check_outcome(out, req.eps)
        _rescore_on_cpu(out, req.env, wl)
        counts[method] = c
        steps = (req.eps // AC_EPISODES if method != "relaxed"
                 else req.eps)
        timing[method] = {
            "platform": req.env.platform, "eps": req.eps, "seconds": secs,
            "best_value": out.best_value, "extras": {
                k: v for k, v in out.extras.items() if k != "history"},
            f"ms_per_{'round' if method == 'relaxed' else 'epoch'}":
                1e3 * secs / steps}
        log(f"[engines] {method}: {json.dumps(timing[method])}; launches "
            f"{json.dumps(c)}")

    # One relaxed request through the service, against its serial run.
    req = dataclasses.replace(reqs["relaxed"], eps=SERVICE_RELAXED_EPS)
    serial, serial_s, _, _ = _counted(lambda: api.run_search(req))
    (svc_outs, tickets, stats, svc_s), secs, c, plain = _counted(
        lambda: service_run(dev, [req]))
    check(_same_outcome(svc_outs[0], serial)
          and svc_outs[0].extras == serial.extras,
          f"relaxed through the service differs from its serial run: "
          f"{svc_outs[0].best_value} vs {serial.best_value}")
    # make_env twice (the adapter's and the service's tables), the probes
    # through the per-row kernel (cache hits launch nothing).
    check(c["cost_eval"] == 2 and c["lstm_cell"] == 0
          and 1 <= c["cost_eval_multi"] <= stats["dispatches"]
          and stats["items"] == req.eps,
          f"relaxed through the service: launches {c}, stats {stats}")
    check(all(v == 0 for v in plain.values()),
          f"relaxed through the service: a plain version ran on the card: "
          f"{plain}")
    counts["relaxed_service"] = c
    timing["relaxed_service"] = {
        "eps": req.eps, "serial_s": serial_s, "seconds": svc_s,
        "dispatches": stats["dispatches"],
        "cache_hit_rate": stats["cache_hit_rate"],
        "ms_per_round": 1e3 * svc_s / req.eps}
    log(f"[engines] relaxed through the service: byte-identical to serial; "
        f"{json.dumps(timing['relaxed_service'])}; launches {json.dumps(c)}")

    # A profiler trace of one short run of each engine (outside the
    # counted runs; make_env and the initial state included).
    traces = {}
    for method, eps in ENGINE_TRACE_EPS.items():
        short = dataclasses.replace(reqs[method], eps=eps)
        trace = _kernel_trace(lambda: api.run_search(short), 1)
        check(trace is not None, f"the profiler trace of {method} shows no "
              "device time")
        trace["eps"] = eps
        trace["kernels"] = trace["kernels"][:12]
        traces[method] = trace
        log(f"[engines] trace of {method} at eps {eps}: "
            f"{trace['wall_ms_per_call']:.3f} ms, device "
            f"{trace['device_us_per_call'] / 1e3:.3f} ms, busy "
            f"{100 * trace['device_busy_share']:.1f}%, "
            f"{trace['launches_per_call']:.0f} device events; by kernel "
            f"(µs, launches): {json.dumps(trace['kernels'][:8])}")
    timing["traces"] = traces
    return counts, timing


class _MultiShapes:
    """Records M of every per-row kernel call (``costmodel_eval.
    cost_eval_multi``, looked up by name on each call) while active."""

    def __enter__(self):
        from repro_torch.kernels import costmodel_eval

        self.ms, self._orig = [], costmodel_eval.cost_eval_multi

        def wrapper(layers, *a):
            self.ms.append(int(layers.shape[0]))
            return self._orig(layers, *a)

        costmodel_eval.cost_eval_multi = wrapper
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import costmodel_eval

        costmodel_eval.cost_eval_multi = self._orig


def _frontier_ecfg(**kw):
    from repro_torch import api

    return api.EnvConfig(**dict(dict(objective="latency", constraint="area",
                                     platform="iot", scenario="LP",
                                     dataflow=0, levels=12), **kw))


def _nsga2_request(wl, eps, **kw):
    from repro_torch import api

    return api.SearchRequest(
        workload=wl, env=_frontier_ecfg(), eps=eps, seed=0, method="nsga2",
        options={"population": NSGA2_POPULATION, "archive": NSGA2_ARCHIVE},
        device="cuda", **kw)


def _check_frontier_on_cpu(out, ecfg, wl, what):
    """The frontier is non-dominated, sorted by latency, within budget, and
    each point re-scored by the plain version on the CPU (rtol 1e-5)."""
    import numpy as np

    from repro_torch.core import env as env_lib
    from repro_torch.core import nsga2

    f = out.frontier
    F = len(f["lat"])
    check(F >= 1 and out.extras["frontier_size"] == F,
          f"{what}: empty frontier")
    check(bool(nsga2.non_dominated_mask(np.stack([f["lat"], f["en"]],
                                                 -1)).all()),
          f"{what}: a frontier point dominates another")
    check(bool(np.all(np.diff(f["lat"]) >= 0)), f"{what}: frontier unsorted")
    env = env_lib.make_env(wl, ecfg, device="cpu")
    tl, te, ta, tp, feas = env_lib.genome_costs_multi(
        env, ecfg, f["pe"], f["kt"], f["df"])
    got = np.stack([t.numpy() for t in (tl, te, ta, tp)], -1)
    want = np.stack([f[k] for k in ("lat", "en", "area", "pw")], -1)
    check(bool(np.allclose(got, want, rtol=1e-5, atol=0)),
          f"{what}: a frontier point does not re-score on the CPU")
    cons = ta if ecfg.constraint == "area" else tp
    check(bool((cons.numpy() <= float(env.budget) * (1 + 1e-6)).all()),
          f"{what}: a frontier point is over the budget on re-scoring")
    return F


def nsga2_generation_traces(dev, generations=NSGA2_TRACE_GENERATIONS):
    """Phase 6c's traces of NSGA-II on mobilenet_v2 at (a)'s size: 20
    generations as the adapter runs them (fitness through
    ``make_local_costs_eval``, then ``evolve``), after 10 warm-up
    generations, each of which also checks the engine's table-kernel
    fitness bit-equal to that; then each selection step alone on the
    state's own costs;
    and ``_front_ranks`` at several check intervals, on the first
    generation's costs and the warm state's."""
    import torch

    from repro_torch.core import env as env_lib
    from repro_torch.core import ga as ga_lib
    from repro_torch.core import nsga2
    from repro_torch.costmodel import workloads
    from repro_torch.serving import batcher

    wl = workloads.get_workload("mobilenet_v2")
    ecfg = _frontier_ecfg()
    env = env_lib.make_env(wl, ecfg, dev)
    cfg = nsga2.NSGA2Config(population=NSGA2_POPULATION,
                            archive=NSGA2_ARCHIVE)
    engine = nsga2.make_nsga2_engine(env, ecfg, cfg)
    fitness = ga_lib.host_fitness(engine.decode,
                                  batcher.make_local_costs_eval(env, ecfg))
    st = [engine.init_carry(0)]

    def costs_of(state):
        return torch.cat([state.parent_costs, fitness(state.pop)])

    first = costs_of(st[0])

    def generation():
        st[0], _ = engine.evolve(st[0], fitness(st[0].pop))

    # The warm-up also holds the engine's own fitness (the table kernel at
    # (P, N)) to the adapter's (the per-row kernel): the same bits.
    for _ in range(10):
        check(torch.equal(engine.fitness(st[0].pop), fitness(st[0].pop)),
              "nsga2: the table-kernel fitness differs from the per-row "
              "kernel's")
        generation()
    ms = time_ms(generation, generations, warmup=0)
    trace = _kernel_trace(generation, generations)
    check(trace is not None, "the profiler trace of NSGA-II shows no device "
          "time")
    trace["unprofiled_ms"] = ms
    trace["device_busy_share_unprofiled"] = (
        trace["device_us_per_call"] / 1e3 / ms)
    trace["kernels"] = trace["kernels"][:12]

    P, cons_col = cfg.population, 2
    costs = costs_of(st[0])
    viol = nsga2._violation(costs, cons_col, env.budget)
    dom = nsga2._constrained_dominance(costs, viol)
    rank = nsga2._front_ranks(dom)
    crowd = nsga2._crowding(costs[:, :2], rank)
    sel = nsga2._select_best(rank, crowd, P)
    genes = st[0].pop.shape[-1]
    pop = st[0].pop
    steps = {
        "fitness": lambda: fitness(pop),
        "dominance": lambda: nsga2._constrained_dominance(
            costs, nsga2._violation(costs, cons_col, env.budget)),
        "front_ranks": lambda: nsga2._front_ranks(dom),
        "crowding": lambda: nsga2._crowding(costs[:, :2], rank),
        "select_best": lambda: nsga2._select_best(rank, crowd, P),
        "archive": lambda: nsga2._update_archive(
            st[0].arch_genomes, st[0].arch_costs, pop, costs[P:], cons_col,
            env.budget),
        "draws_and_breeding": lambda: nsga2._tournament(
            *nsga2._draws(st[0].generator, P, env.num_layers, genes,
                          ecfg.levels, False).tour_a, rank[sel], crowd[sel]),
    }
    by_step = {}
    for name, fn in steps.items():
        t = _kernel_trace(fn, generations)
        check(t is not None, f"the profiler trace of {name} shows no device "
              "time")
        by_step[name] = {"ms": time_ms(fn, generations, warmup=2),
                         "device_us": t["device_us_per_call"],
                         "device_events": t["launches_per_call"]}
    fronts = {}
    for label, c in (("first_generation", first), ("warm", costs)):
        d = nsga2._constrained_dominance(
            c, nsga2._violation(c, cons_col, env.budget))
        row = {"fronts": int(nsga2._front_ranks(d).max()) + 1}
        for every in FRONT_CHECK_INTERVALS:
            row[f"ms_every_{every}"] = time_ms(
                lambda: nsga2._front_ranks(d, every), generations, warmup=2)
        fronts[label] = row
    return {"generation": trace, "by_step": by_step,
            "front_ranks_by_check_interval": fronts}


def frontier_bench(dev):
    """Phase 6c (b): ``benchmarks/bench_frontier.py``'s configs at its quick
    budget through the port, NSGA-II against the 5-weight scalarized GA
    sweep at equal eps, each scored by hypervolume at 1.1x the nadir of
    both frontiers, and at the reference point stored beside the JAX
    package's own run in ``results/frontier.json``."""
    import numpy as np

    from repro_torch import api
    from repro_torch.core import nsga2
    from repro_torch.core import search
    from repro_torch.costmodel import workloads

    ref = json.loads((ROOT / "results" / "frontier.json").read_text())
    rows = {}
    for cname, wname, env_kw, counts in FRONTIER_CONFIGS:
        if wname == "multi_dnn":
            wl = workloads.multi_dnn(list(MIX3_ARCHS), tokens=32)
            eps = max(FRONTIER_EPS // 3, 96)
        else:
            wl = workloads.get_workload(wname)
            eps = FRONTIER_EPS
        ecfg = api.EnvConfig(**env_kw)
        pop = max(min(30, eps // 10), 8)
        t0 = time.perf_counter()
        out = api.run_search(api.SearchRequest(
            workload=wl, env=ecfg, eps=eps, seed=0, method="nsga2",
            options={"population": pop, "archive": 128}, device="cuda"))
        t_nsga2 = time.perf_counter() - t0
        _check_frontier_on_cpu(out, ecfg, wl, f"nsga2 {cname}")
        front = np.stack([out.frontier["lat"], out.frontier["en"]], -1)
        t0 = time.perf_counter()
        sweep = search.scalarized_frontier_sweep(
            wl, ecfg, eps=eps, method="ga", seed=0,
            options={"population": max(min(30, eps // 5 // 4), 8)},
            device="cuda")
        t_sweep = time.perf_counter() - t0
        pts = sweep["points"][:, :2]
        both = np.concatenate([front, pts])
        point = both[np.all(np.isfinite(both), 1)].max(0) * 1.1
        want = ref["configs"][cname]
        stored = np.asarray(want["reference_point"])
        rows[cname] = {
            "eps": eps, "population": pop, "counts": counts,
            "hv_nsga2": nsga2.hypervolume_2d(front, point),
            "hv_sweep": nsga2.hypervolume_2d(pts, point),
            "frontier_size": len(front), "sweep_points": len(pts),
            "reference_point": point.tolist(),
            "hv_nsga2_at_stored_point": nsga2.hypervolume_2d(front, stored),
            "hv_sweep_at_stored_point": nsga2.hypervolume_2d(pts, stored),
            "jax_hv_nsga2": want["hv_nsga2"], "jax_hv_sweep":
                want["hv_sweep"], "jax_frontier_size": want["frontier_size"],
            "best_value": out.best_value,
            "jax_best_value": want["best_value_nsga2"],
            "seconds_nsga2": t_nsga2, "seconds_sweep": t_sweep}
        r = rows[cname]
        r["nsga2_ge_sweep"] = r["hv_nsga2"] >= r["hv_sweep"]
        log(f"[frontier] {cname}: HV nsga2 {r['hv_nsga2']:.6g} vs sweep "
            f"{r['hv_sweep']:.6g} (|front| {r['frontier_size']}, |sweep| "
            f"{r['sweep_points']}); at the JAX run's reference point: port "
            f"nsga2 {r['hv_nsga2_at_stored_point']:.6g}, port sweep "
            f"{r['hv_sweep_at_stored_point']:.6g}, JAX nsga2 "
            f"{r['jax_hv_nsga2']:.6g}, JAX sweep {r['jax_hv_sweep']:.6g}"
            + ("" if counts else " (reported, not counted)"))
    n_pass = sum(r["nsga2_ge_sweep"] for r in rows.values() if r["counts"])
    check(n_pass >= 3, f"nsga2 hypervolume >= the sweep's on {n_pass} of "
          "4 standard configs, fewer than 3")
    return {"configs": rows, "n_pass": n_pass}


def phase_frontier(dev):
    """Phase 6c: NSGA-II at full width, the frontier benchmark's
    counterpart, NSGA-II through the service, and Fig. 5's heuristics."""
    import dataclasses

    import numpy as np

    from repro_torch import api
    from repro_torch.core import env as env_lib
    from repro_torch.core import search
    from repro_torch.costmodel import workloads

    wl = workloads.get_workload("mobilenet_v2")
    N, G = len(wl), NSGA2_EPS // NSGA2_POPULATION
    counts, timing = {}, {}

    # (a) One counted run: make_env scores C_max once; each generation is
    # one per-row launch over its P x N points.
    req = _nsga2_request(wl, NSGA2_EPS)
    with _MultiShapes() as shapes:
        out, secs, c, plain = _counted(lambda: api.run_search(req))
    _check_launches("nsga2", c, plain, {"cost_eval": 1,
                                        "cost_eval_multi": G})
    check(shapes.ms == [NSGA2_POPULATION * N] * G,
          f"nsga2: per-row kernel M over its launches {set(shapes.ms)}, "
          f"expected {NSGA2_POPULATION * N}")
    _check_outcome(out, req.eps)
    _rescore_on_cpu(out, req.env, wl)
    F = _check_frontier_on_cpu(out, req.env, wl, "nsga2")
    counts["nsga2"] = c
    timing["nsga2"] = {"eps": req.eps, "generations": G, "seconds": secs,
                       "ms_per_generation": 1e3 * secs / G,
                       "best_value": out.best_value, "frontier_size": F}
    log(f"[frontier] nsga2 mobilenet_v2 P={NSGA2_POPULATION} A="
        f"{NSGA2_ARCHIVE} eps={req.eps}: {json.dumps(timing['nsga2'])}; "
        f"launches {json.dumps(c)}, per-row M {NSGA2_POPULATION * N}")
    traces = nsga2_generation_traces(dev)
    tr = traces["generation"]
    log(f"[frontier] trace of {tr['calls']} generations: "
        f"{tr['unprofiled_ms']:.3f} ms each unprofiled, device "
        f"{tr['device_us_per_call'] / 1e3:.3f} ms, busy "
        f"{100 * tr['device_busy_share_unprofiled']:.1f}% of the "
        f"unprofiled time, {tr['launches_per_call']:.1f} device events "
        f"each; by kernel (µs, launches each): "
        f"{json.dumps(tr['kernels'][:8])}")
    log(f"[frontier] by selection step (ms, device µs, device events a "
        f"call): {json.dumps(traces['by_step'])}")
    log(f"[frontier] _front_ranks by check interval (ms a call): "
        f"{json.dumps(traces['front_ranks_by_check_interval'])}")
    timing["traces"] = traces

    # (b) The frontier benchmark's counterpart.
    bench, secs, c, plain = _counted(lambda: frontier_bench(dev))
    check(all(v == 0 for v in plain.values()),
          f"frontier bench: a plain version ran on the card: {plain}")
    counts["bench"] = c
    timing["bench"] = dict(bench, seconds=secs)

    # (c) NSGA-II through the service beside a ga request, against serial
    # runs.  The NSGA-II request streams progress (the service always
    # does), so both runs take the same chunks and frontier snapshots.
    def reqs():
        return [_nsga2_request(wl, SERVICE_NSGA2_EPS,
                               on_progress=lambda t: None,
                               progress_every=3 * NSGA2_POPULATION),
                dataclasses.replace(_service_requests(
                    [SERVICE_REQUESTS[0]])[0], eps=SERVICE_GA_EPS)]
    serial, serial_s, _, _ = _counted(lambda: [api.run_search(r)
                                               for r in reqs()])
    (svc_outs, _, stats, svc_s), secs, c, plain = _counted(
        lambda: service_run(dev, reqs()))
    for got, want in zip(svc_outs, serial):
        check(_same_outcome(got, want), f"{got.method} through the service "
              f"differs from its serial run: {got.best_value} vs "
              f"{want.best_value}")
    got, want = svc_outs[0], serial[0]
    check(all(np.array_equal(got.frontier[k], want.frontier[k])
              for k in want.frontier)
          and len(got.extras["frontier_trace"])
          == len(want.extras["frontier_trace"]) > 1
          and all(a.tobytes() == b.tobytes() for a, b in zip(
              got.extras["frontier_trace"], want.extras["frontier_trace"])),
          "nsga2 through the service: frontier or frontier trace differs "
          "from the serial run")
    check(1 <= c["cost_eval_multi"] <= stats["dispatches"]
          and all(v == 0 for v in plain.values()),
          f"nsga2 through the service: launches {c}, plain versions on the "
          f"card {plain}, {stats['dispatches']} dispatches")
    counts["service"] = c
    timing["service"] = {
        "eps": SERVICE_NSGA2_EPS, "ga_eps": SERVICE_GA_EPS,
        "serial_s": serial_s, "seconds": svc_s,
        "dispatches": stats["dispatches"],
        "cache_hit_rate": stats["cache_hit_rate"],
        "frontier_trace_snapshots": len(got.extras["frontier_trace"])}
    log(f"[frontier] nsga2 + ga through the service: byte-identical to "
        f"serial, frontier and trace included; "
        f"{json.dumps(timing['service'])}; launches {json.dumps(c)}")

    # (d) Fig. 5's heuristics, each re-scored on the CPU.
    ecfg = _frontier_ecfg()
    heur = {}
    for name, want_cost in (("heuristic_a", 4), ("heuristic_b", 2)):
        h, secs, c, plain = _counted(
            lambda: getattr(search, name)(wl, ecfg, device="cuda"))
        _check_launches(name, c, plain, {"cost_eval": want_cost})
        env = env_lib.make_env(wl, ecfg, device="cpu")
        perf, _, feas = env_lib.genome_cost(env, ecfg, h["pe"], h["kt"],
                                            float(ecfg.dataflow))
        cpu = float(perf) if bool(feas) else float("inf")
        check(cpu == h["value"] or abs(cpu - h["value"])
              <= 1e-5 * abs(h["value"]),
              f"{name}: {h['value']} on the card, {cpu} re-scored on the CPU")
        counts[name] = c
        heur[name] = {"value": h["value"], "seconds": secs,
                      "hot_layer": h.get("hot_layer"),
                      "pe": sorted(set(h["pe"].tolist())),
                      "kt": sorted(set(h["kt"].tolist()))}
    timing["heuristics"] = heur
    log(f"[frontier] Fig. 5 heuristics on mobilenet_v2 / iot: "
        f"{json.dumps(heur)}")
    return counts, timing


def _fanout_request(inner, n_shards, backend, eps, inner_opts, platform,
                    env_kw=None):
    """A fanout request on mobilenet_v2 at full width (LSTM(128), L = 12,
    latency / area / dla, LP unless ``env_kw`` says otherwise), seed 0."""
    from repro_torch import api
    from repro_torch.costmodel import workloads

    env_kw = env_kw or FANOUT_ENV
    return api.SearchRequest(
        workload=workloads.get_workload("mobilenet_v2"),
        env=api.EnvConfig(platform=platform, **env_kw), eps=eps, seed=0,
        method="fanout",
        options={"inner": inner, "n_shards": n_shards, "backend": backend,
                 "inner_options": dict(inner_opts)},
        device="cuda")


def _same_fanout(a, b):
    """Two fanout outcomes equal byte for byte: best value, history, pe,
    kt, df, and every extra but the backend."""
    ea = {k: v for k, v in a.extras.items() if k != "backend"}
    eb = {k: v for k, v in b.extras.items() if k != "backend"}
    return _same_outcome(a, b) and ea == eb


def _fanout_launches(inner, eps, opts, n_shards, N=53):
    """The launches ``n_shards`` shards of ``inner`` imply: per shard,
    make_env's one table launch and the engine's (the LSTM forward a
    lower bound for reinforce, checked as phase 6 does)."""
    if inner == "reinforce":
        return {"cost_eval": n_shards * (1 + N * eps),
                "lstm_cell": n_shards * N * eps}
    if inner == "ga":
        return {"cost_eval": n_shards * (1 + eps // opts["population"])}
    if inner == "sa":       # the initial genome, then one a step
        return {"cost_eval": n_shards * (1 + 1 + eps)}
    if inner == "two_stage":
        return {"cost_eval": n_shards * (1 + N * eps
                                         + opts["ga"]["generations"]),
                "lstm_cell": n_shards * N * eps}
    raise ValueError(inner)


def _union_trace(fn, steps):
    """A profiler trace of ``fn()`` (``steps`` fleet steps): wall ms,
    device time summed over kernels, the union of the kernels' device
    intervals (the time the card had at least one kernel running), the
    busy share (union over wall) and the concurrency (sum over union);
    None where the trace shows no device time (taken twice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        spans = _device_spans(prof)
        if spans:
            break
    else:
        return None
    total = sum(b - a for a, b in spans)
    union = _span_union(spans)
    return {"steps": steps, "wall_ms": wall_us / 1e3,
            "device_ms_summed": total / 1e3, "device_ms_union": union / 1e3,
            "busy_share": union / wall_us,
            "concurrency": total / union if union else None,
            "device_events": len(spans)}


def _fanout_fleet_times(n_shards, epochs):
    """The device backend's reinforce fleet (phase 6d (b)'s config) at
    ``n_shards``, built (captures included) outside the timings: ms a
    fleet epoch over ``FANOUT_TIMED_EPOCHS`` unprofiled epochs (host clock
    around work that ends in a sync); the host ms one epoch's replay call
    takes to return with the card idle (the median of 20: ``n_shards``
    of them a fleet epoch is the most the host can launch); then a
    profiler trace of ``epochs`` fleet epochs (:func:`_union_trace`)."""
    import dataclasses
    import statistics

    import torch

    from repro_torch.distributed import dist_search

    eps, opts, platform = FANOUT_WALL_RUNS["reinforce"]
    req = dataclasses.replace(
        _fanout_request("reinforce", 1, "device", eps, opts, platform),
        method="reinforce", options={})
    subs = [dataclasses.replace(req, seed=s) for s in range(n_shards)]
    _, _, fleet = dist_search.reinforce_fleet(
        subs, max(epochs, FANOUT_TIMED_EPOCHS))
    fleet.run(1)
    t0 = time.perf_counter()
    fleet.run(FANOUT_TIMED_EPOCHS)           # ends in a sync
    ms = 1e3 * (time.perf_counter() - t0) / FANOUT_TIMED_EPOCHS
    launch = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.runners[0].step()
        launch.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {"shards": n_shards, "ms_per_fleet_epoch": ms,
            "ms_per_shard_epoch": ms / n_shards,
            "host_ms_per_replay": statistics.median(launch),
            "trace": _union_trace(lambda: fleet.run(epochs), epochs)}


def _fanout_checks():
    """Phase 6d (a): each backend of ``FANOUT_CHECK_RUNS`` against serial,
    byte for byte, the launches exact and equal, no plain version on the
    card, at least one shard feasible."""
    import numpy as np

    from repro_torch import api

    counts, timing = {}, {}
    n = FANOUT_CHECK_SHARDS
    for inner, (eps, opts, platform, backends) in FANOUT_CHECK_RUNS.items():
        want = _fanout_launches(inner, eps, opts, n)
        runs = {}
        for backend in ("serial",) + backends:
            out, secs, c, plain = _counted(lambda: api.run_search(
                _fanout_request(inner, n, backend, eps, opts, platform)))
            _check_run_launches(f"fanout {inner} {backend}", inner, c,
                                plain, want)
            check(out.extras["backend"] == backend,
                  f"fanout {inner}: ran on {out.extras['backend']}, asked "
                  f"for {backend}")
            runs[backend] = (out, secs, c)
            counts[f"{inner}_{backend}"] = c
        serial, _, c_serial = runs["serial"]
        check(any(np.isfinite(v) for v in serial.extras["shard_best_values"]),
              f"fanout {inner}: no shard feasible, so the bytes compare "
              "infeasible traces only")
        for backend in backends:
            out, _, c = runs[backend]
            check(_same_fanout(out, serial),
                  f"fanout {inner}: {backend} differs from serial: "
                  f"{out.extras['shard_best_values']} vs "
                  f"{serial.extras['shard_best_values']}")
            check(c == c_serial, f"fanout {inner}: {backend}'s launches "
                  f"{c} differ from serial's {c_serial}")
        timing[inner] = {
            "eps": eps, "platform": platform, "shards": n,
            "shard_best_values": serial.extras["shard_best_values"],
            **{f"{b}_s": runs[b][1] for b in runs}}
        log(f"[fanout] {inner}: {', '.join(backends)} byte-identical to "
            f"serial, launches equal {json.dumps(c_serial)}; "
            f"{json.dumps(timing[inner])}")
    return counts, timing


def _fanout_walls():
    """Phase 6d (b): wall seconds of every backend at 4 and 10 shards;
    each run counted and held to serial's bytes and launches.  The
    10-shard reinforce runs are the quality check's Q2 when its config
    matches.  Then profiler traces of the device backend's fleet."""
    from repro_torch import api

    counts, timing, outs = {}, {}, {}
    for inner, (eps, opts, platform) in FANOUT_WALL_RUNS.items():
        for n in FANOUT_WALL_SHARDS:
            want = _fanout_launches(inner, eps, opts, n)
            row, serial, c_serial = {}, None, None
            for backend in ("serial", "threads", "device"):
                out, secs, c, plain = _counted(lambda: api.run_search(
                    _fanout_request(inner, n, backend, eps, opts, platform)))
                what = f"fanout {inner} x{n} {backend}"
                _check_run_launches(what, inner, c, plain, want)
                if serial is None:
                    serial, c_serial = out, c
                else:
                    check(_same_fanout(out, serial) and c == c_serial,
                          f"{what} differs from serial: "
                          f"{out.extras['shard_best_values']} vs "
                          f"{serial.extras['shard_best_values']}; launches "
                          f"{c} vs {c_serial}")
                row[f"{backend}_s"] = secs
                counts[f"{inner}_x{n}_{backend}"] = c
            row["threads_speedup"] = row["serial_s"] / row["threads_s"]
            row["device_speedup"] = row["serial_s"] / row["device_s"]
            row["shard_best_values"] = serial.extras["shard_best_values"]
            timing[f"{inner}_x{n}"] = row
            outs[(inner, n)] = serial
            log(f"[fanout] walls {inner} x{n} (eps {eps}, {platform}): "
                f"{json.dumps(row)}")
    traces = {}
    for n, epochs in FANOUT_TRACE_EPOCHS.items():
        t = traces[f"reinforce_x{n}"] = _fanout_fleet_times(n, epochs)
        one = traces["reinforce_x1"]["ms_per_fleet_epoch"] if n > 1 else None
        t["overlap"] = n * one / t["ms_per_fleet_epoch"] if one else 1.0
        tr = t["trace"]
        msg = (f"[fanout] device fleet x{n}: {t['ms_per_fleet_epoch']:.3f} "
               f"ms a fleet epoch unprofiled ({t['ms_per_shard_epoch']:.3f} "
               f"a shard-epoch; {t['overlap']:.2f} x one shard's rate); a "
               f"replay call returns after {t['host_ms_per_replay']:.3f} ms "
               "of host time with the card idle")
        if tr is None:
            msg += "; its trace shows no device time (not measured)"
        else:
            msg += (f"; traced {epochs} epochs: {tr['wall_ms'] / epochs:.3f} "
                    f"ms a fleet epoch, busy {100 * tr['busy_share']:.1f}% "
                    f"(union of kernel intervals over the wall), device "
                    f"{tr['device_ms_summed'] / epochs:.3f} ms summed / "
                    f"{tr['device_ms_union'] / epochs:.3f} ms union a fleet "
                    f"epoch, concurrency {tr['concurrency']:.2f}, "
                    f"{tr['device_events'] / epochs / n:.0f} events a "
                    "shard-epoch")
        log(msg)
    timing["traces"] = traces
    return counts, timing, outs


def _u_null_cdf(n, m):
    """P(U <= u), u = 0 .. n * m, of the Mann-Whitney U of samples of n
    and m without ties under the null (exact counts)."""
    import math

    import numpy as np

    # ways[i][j]: counts of U over arrangements of i and j values.
    ways = {(0, j): np.ones(1) for j in range(m + 1)}
    ways.update({(i, 0): np.ones(1) for i in range(n + 1)})
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            w = np.zeros(i * j + 1)
            a, b = ways[(i - 1, j)], ways[(i, j - 1)]
            w[j:j + len(a)] += a      # the largest value is from the first
            w[:len(b)] += b
            ways[(i, j)] = w
    return np.cumsum(ways[(n, m)]) / math.comb(n + m, n)


def _quality_stats(port, ref, conf=0.95):
    """Medians, interquartile ranges, the port's median over the
    reference's, Mann-Whitney U p-values (two-sided, and one-sided for
    the port worse: larger, the objective is minimized), and the
    Hodges-Lehmann shift (port - reference) with its ``conf`` interval
    from the exact null distribution of U.  inf (infeasible) ranks last;
    inf - inf counts as no shift."""
    import numpy as np
    from scipy import stats

    port, ref = np.asarray(port, float), np.asarray(ref, float)
    q = lambda x: [float(v) for v in np.percentile(x, [25, 50, 75])]
    d = np.subtract.outer(port, ref).ravel()
    d = np.sort(np.where(np.isnan(d), 0.0, d))
    cdf = _u_null_cdf(len(port), len(ref))
    k = int(np.searchsorted(cdf, (1 - conf) / 2, side="right")) - 1
    lo, hi = (float(d[k]), float(d[len(d) - 1 - k])) if k >= 0 else (
        float("-inf"), float("inf"))
    pq, rq = q(port), q(ref)
    return {"port_median": pq[1], "port_iqr": [pq[0], pq[2]],
            "ref_median": rq[1], "ref_iqr": [rq[0], rq[2]],
            "median_ratio": pq[1] / rq[1],
            "p_two_sided": float(stats.mannwhitneyu(
                port, ref, alternative="two-sided").pvalue),
            "p_port_worse": float(stats.mannwhitneyu(
                port, ref, alternative="greater").pvalue),
            "hl_shift": float(np.median(d)), "hl_interval": [lo, hi],
            "hl_interval_coverage": float(1 - 2 * cdf[k]) if k >= 0 else 1.0,
            "lost_seeds": int(np.sum(np.isinf(port) & np.isfinite(ref)))}


def _quality_row(ref, name, port, tag, what, **info):
    """The quality table's row of config ``name``: the port's best values
    ``port`` (seeds 0-9) against the file's entries, with ``info``;
    logged as ``[tag] quality name (what): ...``."""
    import numpy as np

    entries = sorted((e for e in ref["entries"] if e["config"] == name),
                     key=lambda e: e["seed"])
    check([e["seed"] for e in entries] == list(range(QUALITY_SHARDS)),
          f"quality {name}: the file's seeds are not 0-9")
    refv = [float("inf") if e["best_value"] is None
            else float(e["best_value"]) for e in entries]
    st = _quality_stats(port, refv)
    st.update(info, port=port, ref=refv,
              port_feasible=int(np.isfinite(port).sum()),
              ref_feasible=int(np.isfinite(refv).sum()))
    log(f"[{tag}] quality {name} ({what}): port median "
        f"{st['port_median']:.6g} IQR {st['port_iqr']}, reference "
        f"{st['ref_median']:.6g} IQR {st['ref_iqr']}; ratio "
        f"{st['median_ratio']:.4f}; Mann-Whitney p two-sided "
        f"{st['p_two_sided']:.4g}, port worse {st['p_port_worse']:.4g}; "
        f"Hodges-Lehmann shift {st['hl_shift']:.6g}, "
        f"{100 * st['hl_interval_coverage']:.1f}% interval "
        f"{st['hl_interval']}; feasible {st['port_feasible']} / "
        f"{st['ref_feasible']}")
    return st


def _quality_gate(name, st):
    """Fail where the port is worse at one-sided p < ``QUALITY_P_WORSE``
    or infeasible on more than ``QUALITY_MAX_LOST`` seeds where the
    reference is feasible."""
    check(st["p_port_worse"] >= QUALITY_P_WORSE,
          f"quality {name}: the port is worse than the reference, "
          f"one-sided p = {st['p_port_worse']:.4g}")
    check(st["lost_seeds"] <= QUALITY_MAX_LOST,
          f"quality {name}: the port is infeasible on "
          f"{st['lost_seeds']} seeds where the reference is feasible")


def _fanout_quality(wall_outs):
    """Phase 6d (c): each config of the JAX package's file through the
    port's fanout at ``QUALITY_SHARDS`` shards, seed 0, against the
    reference's seeds 0-9 (the runs of phase (b) where a config is
    theirs); fails where the port is worse at one-sided p <
    ``QUALITY_P_WORSE`` or loses more than ``QUALITY_MAX_LOST`` seeds."""
    from repro_torch import api

    check(QUALITY_REF.is_file(), f"{QUALITY_REF} is missing: write it with "
          "tools/search_quality_ref.py")
    ref = json.loads(QUALITY_REF.read_text())
    check(ref["workload"] == "mobilenet_v2", "quality file: workload")
    table, counts = {}, {}
    for name, cfg in ref["configs"].items():
        method, platform, eps = cfg["method"], cfg["platform"], cfg["eps"]
        if name == DIST_QUALITY:        # phase 6e's
            continue
        backend = QUALITY_BACKENDS[method]
        req = _fanout_request(method, QUALITY_SHARDS, backend, eps,
                              cfg["options"], platform, ref["env"])
        wall = FANOUT_WALL_RUNS.get(method)
        if (wall == (eps, cfg["options"], platform)
                and QUALITY_SHARDS in FANOUT_WALL_SHARDS
                and backend == "device" and ref["env"] == FANOUT_ENV):
            out, secs = wall_outs[(method, QUALITY_SHARDS)], None
        else:
            out, secs, c, plain = _counted(lambda: api.run_search(req))
            _check_run_launches(
                f"quality {name}", method, c, plain, _fanout_launches(
                    method, eps, cfg["options"], QUALITY_SHARDS))
            counts[name] = c
        table[name] = _quality_row(
            ref, name, [float(v) for v in out.extras["shard_best_values"]],
            "fanout", f"{method}, {platform}, eps {eps}, {backend}",
            method=method, platform=platform, eps=eps, backend=backend,
            seconds=secs)
    for name, st in table.items():
        _quality_gate(name, st)
    return counts, {"reference": {k: ref[k] for k in
                                  ("jax_version", "command", "seeds")},
                    "configs": table}


def phase_fanout():
    """Phase 6d: the fanout wrapper on the card -- (a) each backend held to
    serial, (b) walls and the device fleet's traces, (c) the
    search-quality check against the JAX package's seeds."""
    check_counts, checks = _fanout_checks()
    wall_counts, walls, wall_outs = _fanout_walls()
    quality_counts, quality = _fanout_quality(wall_outs)
    counts = {**check_counts, **wall_counts,
              **{f"quality_{k}": v for k, v in quality_counts.items()}}
    return counts, {"checks": checks, "walls": walls, "quality": quality}


def _dist_mask(n):
    return [i not in DIST_DEAD for i in range(n)]


def _same_state(a, b):
    """Two stage-1 states with the same bits: params, Adam state, pmin,
    best, epoch and the generator."""
    import torch

    from repro_torch.core import reinforce

    same = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))
    return (same(a.params.parameters(), b.params.parameters())
            and same(reinforce.state_tensors(a), reinforce.state_tensors(b))
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def _graphed_epoch_ms(runner, trace=True):
    """CUDA-event ms a replay of ``runner``'s epoch graph over
    ``DIST_TIMED_EPOCHS`` replays, and (with ``trace``) a profiler trace
    of ``DIST_TRACE_EPOCHS`` of them: device time by kernel, and the busy
    share as the union of the device intervals over that trace's own
    wall time, as phase 6d reads it."""
    ms = time_ms(runner.step, DIST_TIMED_EPOCHS, warmup=2)
    if not trace:
        return ms, None
    tr = _kernel_trace(runner.step, DIST_TRACE_EPOCHS)
    check(tr is not None, "the trace of graphed dist_reinforce epochs "
          "shows no device time")
    return ms, tr


def _dist_case(dev, shape, axes, E, compress):
    """Phase 6e (a)-(b) for one mesh and pod hop: ``run_distributed_search``'s
    runner (``EpochRunner`` over ``make_inplace_distributed_epoch``, one
    CUDA graph) built, then ``DIST_EPOCHS`` replays counted, the launches
    exact, against as many eager epochs of ``make_distributed_epoch`` bit
    for bit; then ms an epoch graphed and a trace of graphed epochs."""
    import torch

    from repro_torch.core import reinforce
    from repro_torch.distributed import collectives, dist_search
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1_setup(dev, DIST_EPOCHS)
    mesh = collectives.VirtualMesh(shape, axes, dev)
    dcfg = dist_search.DistConfig(episodes_per_device=E,
                                  compress_pod_axis=compress)
    alive = collectives.alive_flags(mesh, _dist_mask(mesh.size))
    what = f"dist_reinforce {shape} E={E} {'int8' if compress else 'f32'}"
    opt = optim.Adam(lr=rcfg.lr)
    runner = reinforce.EpochRunner(
        reinforce.init_search(env, ecfg, pcfg, rcfg, opt),
        dist_search.make_inplace_distributed_epoch(
            ecfg, pcfg, rcfg, env, opt, mesh, alive, dcfg),
        DIST_TIMED_EPOCHS, names=dist_search.DIST_METRICS)
    hist, secs, counts, plain = _counted(lambda: runner.run(DIST_EPOCHS))
    want = _dist_launches(DIST_EPOCHS * E * mesh.size, shape, axes, E,
                          compress, env.num_layers, make_env=False)
    _check_launches(what, counts, plain, want)

    opt = optim.Adam(lr=rcfg.lr)
    st = reinforce.init_search(env, ecfg, pcfg, rcfg, opt)
    epoch_fn = dist_search.make_distributed_epoch(
        ecfg, pcfg, rcfg, env, opt, mesh, alive, dcfg)
    metrics = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_EPOCHS):
        st, m = epoch_fn(st)
        metrics.append(m)
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / DIST_EPOCHS
    for k in dist_search.DIST_METRICS:
        w = torch.stack([m[k] for m in metrics]).cpu().numpy()
        check(hist[k].tobytes() == w.tobytes(),
              f"{what}: graphed {k} differs from the eager epochs': "
              f"{hist[k]} vs {w}")
    check(_same_state(runner.state, st),
          f"{what}: the graphed state differs from the eager epochs'")
    best = float(runner.state.best_value)

    graphed_ms, trace = _graphed_epoch_ms(runner)
    per_epoch = {k: v // DIST_EPOCHS for k, v in want.items()}
    out = {"mesh": list(shape), "axes": list(axes), "E": E,
           "B": E * mesh.size, "compress": compress, "dead": list(DIST_DEAD),
           "epochs": DIST_EPOCHS, "bit_equal": True,
           "launches_per_epoch": per_epoch,
           "graphed_run_s": secs, "eager_ms": eager_ms,
           "graphed_ms": graphed_ms, "best_value": best,
           "feasible_frac_last": float(hist["feasible_frac"][-1]),
           "trace": trace}
    log(f"[dist] {what}: {DIST_EPOCHS} graphed epochs bit-equal to eager, "
        f"launches exact {json.dumps(counts)} ({json.dumps(per_epoch)} an "
        f"epoch); {eager_ms:.3f} ms an epoch eager, {graphed_ms:.3f} ms "
        f"graphed; trace of {DIST_TRACE_EPOCHS} graphed epochs: device "
        f"{trace['device_us_per_call'] / 1e3:.3f} ms an epoch, busy "
        f"{100 * trace['device_busy_share_union']:.1f}% (the device "
        f"intervals' union over the traced wall, "
        f"{trace['wall_ms_per_call']:.3f} ms an epoch), "
        f"{trace['launches_per_call']:.0f} device events "
        f"an epoch; by kernel (us, launches an epoch): "
        f"{json.dumps(trace['kernels'][:8])}")
    return counts, out


def _reinforce_epoch_ms(dev, B):
    """A stage-1 epoch of ``reinforce`` at ``episodes_per_epoch`` B, graphed
    (CUDA-event ms a replay): the same rollout and one backward pass,
    with the entropy term's and without the reductions."""
    import dataclasses

    from repro_torch.core import reinforce
    from repro_torch.training import optim

    wl, ecfg, pcfg, rcfg, env = _stage1_setup(dev, DIST_EPOCHS)
    rcfg = dataclasses.replace(rcfg, episodes_per_epoch=B)
    opt = optim.Adam(lr=rcfg.lr)
    runner = reinforce.EpochRunner(
        reinforce.init_search(env, ecfg, pcfg, rcfg, opt),
        reinforce.make_inplace_epoch_fn(ecfg, pcfg, rcfg, env, opt),
        DIST_TIMED_EPOCHS)
    ms, _ = _graphed_epoch_ms(runner, trace=False)
    log(f"[dist] reinforce at episodes_per_epoch {B}: {ms:.3f} ms an epoch "
        "graphed")
    return {"B": B, "graphed_ms": ms}


def _dist_nccl(dev):
    """Phase 6e (c): a ``ProcessMesh`` world of one rank under NCCL (a
    ``HashStore``, no network) against ``VirtualMesh((1,), ("data",))``:
    ``DIST_NCCL_EPOCHS`` epochs at E = 2 under the cloud budget (so that
    the best is feasible), the same bits (the rank runs eagerly, the
    virtual mesh through its graph)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.core import env as env_lib
    from repro_torch.distributed import collectives, dist_search

    wl, ecfg, pcfg, rcfg, _ = _stage1_setup(dev, DIST_NCCL_EPOCHS)
    ecfg = dataclasses.replace(ecfg, platform="cloud")   # a finite best
    env = env_lib.make_env(wl, ecfg, dev)
    dcfg = dist_search.DistConfig(episodes_per_device=2)
    virt, vhist = dist_search.run_distributed_search(
        wl, ecfg, collectives.VirtualMesh((1,), ("data",), dev), rcfg, dcfg,
        pcfg, env=env)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = collectives.ProcessMesh((1,), ("data",))
        t0 = time.perf_counter()
        rank, rhist = dist_search.run_distributed_search(
            wl, ecfg, mesh, rcfg, dcfg, pcfg, env=env)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    check(_same_state(rank, virt)
          and all(rhist[k].tobytes() == vhist[k].tobytes()
                  for k in dist_search.DIST_METRICS),
          "dist_reinforce: the NCCL world of one rank differs from the "
          "virtual mesh of one device")
    out = {"epochs": DIST_NCCL_EPOCHS, "E": 2, "bit_equal": True,
           "process_mesh_s": secs, "best_value": float(rank.best_value)}
    log(f"[dist] nccl world of one rank == VirtualMesh((1,)): "
        f"{json.dumps(out)}")
    return out


def _dist_quality(dev):
    """Phase 6e (d): the quality file's ``DIST_QUALITY`` config
    (dist_reinforce on a virtual mesh of its shape) for seeds 0-9 through
    ``api.run_search``, counted, against the JAX package's seeds; fails
    where the port is worse at one-sided p < ``QUALITY_P_WORSE`` or
    infeasible on more than ``QUALITY_MAX_LOST`` seeds where the
    reference is feasible."""
    from repro_torch import api
    from repro_torch.distributed import collectives

    ref = json.loads(QUALITY_REF.read_text())
    check(DIST_QUALITY in ref["configs"], f"quality file: no "
          f"{DIST_QUALITY}; write it with tools/search_quality_ref.py "
          f"--configs {DIST_QUALITY}")
    cfg = ref["configs"][DIST_QUALITY]
    method, platform, eps = cfg["method"], cfg["platform"], cfg["eps"]
    shape, axes = cfg["options"]["mesh"]
    opts = dict(cfg["options"],
                mesh=collectives.VirtualMesh(shape, axes, dev))
    seeds = ref["seeds"]
    outs, secs, counts, plain = _counted(lambda: [api.run_search(
        api.SearchRequest(
            workload=ref["workload"],
            env=api.EnvConfig(platform=platform, **ref["env"]), eps=eps,
            seed=s, method=method, options=dict(opts), device="cuda"))
        for s in seeds])
    one = _dist_launches(eps, shape, axes, opts["episodes_per_device"],
                         opts["compress_pod_axis"])
    _check_launches(f"quality {DIST_QUALITY}", counts, plain,
                    {k: len(seeds) * v for k, v in one.items()})
    st = _quality_row(
        ref, DIST_QUALITY, [float(o.best_value) for o in outs], "dist",
        f"{method}, {platform}, eps {eps}, mesh {shape} {axes}, "
        f"{secs:.1f} s for {len(seeds)} seeds",
        method=method, platform=platform, eps=eps, seconds=secs)
    _quality_gate(DIST_QUALITY, st)
    return counts, st


def phase_dist(dev):
    """Phase 6e: dist_reinforce on the card -- (a, b) each mesh of
    ``DIST_RUNS`` with the pod hop in f32 and in int8, graph against eager
    and timed, beside reinforce at the same batch; (c) an NCCL world of
    one rank; (d) the quality check of ``DIST_QUALITY``."""
    counts, cases, beside = {}, {}, {}
    for shape, axes, E in DIST_RUNS:
        for compress in (False, True):
            name = f"{'x'.join(map(str, shape))}_E{E}_" + (
                "int8" if compress else "f32")
            counts[name], cases[name] = _dist_case(dev, shape, axes, E,
                                                   compress)
        B = E * math.prod(shape)
        beside[f"reinforce_B{B}"] = _reinforce_epoch_ms(dev, B)
    nccl = _dist_nccl(dev)
    counts["quality"], quality = _dist_quality(dev)
    return counts, {"cases": cases, "reinforce": beside, "nccl": nccl,
                    "quality": quality}


def _route_check(dev, base, layers):
    """Float32 weights at ``layers`` layers of ``base``, LM_F32_STEPS greedy
    steps of LM_F32_BATCH requests through the kernel and again through
    the plain version (on the CPU for a family that reaches no kernel):
    equal tokens, logits within atol / rtol 1e-4.  Both routes run the
    same float32 products; only the attention's order of sums differs."""
    import dataclasses

    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm

    cfg = dataclasses.replace(base, num_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, device=dev)
    first = torch.randint(0, cfg.vocab_size, (LM_F32_BATCH,), generator=gen,
                          device=dev)
    feats = _frontend_feats(cfg, dev, 1)
    toks_k, logits_k = _greedy(model, cfg, first, LM_F32_STEPS, dev, feats)
    if lm.attention_sites(cfg) + lm.cross_sites(cfg):
        against = "plain route"
        kernel_route = ops.decode_attention
        ops.decode_attention = ref.flash_decode_ref
        try:
            toks_p, logits_p = _greedy(model, cfg, first, LM_F32_STEPS, dev,
                                       feats)
        finally:
            ops.decode_attention = kernel_route
    else:
        against = "CPU"
        cpu = lm.LM(cfg, "cpu")
        cpu.load_state_dict(model.state_dict())
        toks_p, logits_p = _greedy(cpu, cfg, first.cpu(), LM_F32_STEPS,
                                   "cpu")
    torch.cuda.synchronize()
    toks_k, logits_k = toks_k.cpu(), logits_k.cpu()
    toks_p, logits_p = toks_p.cpu(), logits_p.cpu()
    err = float((logits_k - logits_p).abs().max())
    check(bool(logits_k.isfinite().all()), f"{base.name} f32 logits not "
          "finite")
    check(torch.equal(toks_k, toks_p), f"{base.name} f32: the card's "
          f"tokens {toks_k.T.tolist()} differ from the {against}'s "
          f"{toks_p.T.tolist()}")
    check(torch.allclose(logits_k, logits_p, rtol=1e-4, atol=1e-4),
          f"{base.name} f32: logits differ from the {against}'s by {err}")
    del model, logits_k, logits_p
    torch.cuda.empty_cache()
    return {"layers": layers, "against": against, "max_abs_diff": err}


def _engine_run(dev, cfg, model, feats, prompt_lens, max_len):
    """``serving.Engine`` on ``cfg``'s model: a warm-up request, then
    LM_REQUESTS ``synthetic_requests`` (``prompt_lens``, LM_MAX_NEW new
    tokens, ``max_len``, LM_MAX_BATCH), counters set to 0 just before and
    read just after.  Checks the decode steps the run implies,
    flash_decode launched once per attention site (self and cross) per
    step, no plain version on the card, and every request complete and
    in range.  Returns the launch counts and the run's record."""
    import torch

    from repro_torch.kernels import ops, ref
    from repro_torch.models import lm
    from repro_torch.serving import Engine, ServeConfig, synthetic_requests

    eng = Engine(cfg, model, ServeConfig(max_len=max_len,
                                         max_batch=LM_MAX_BATCH),
                 cross_feats=feats)
    eng.serve(synthetic_requests(1, cfg.vocab_size, prompt_lens=(4,),
                                 max_new=2, seed=1))          # warm-up
    reqs = synthetic_requests(LM_REQUESTS, cfg.vocab_size,
                              prompt_lens=prompt_lens, max_new=LM_MAX_NEW,
                              seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps0 = eng.decode_steps
    ops.reset_launch_counts()
    stats = eng.serve(reqs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    plain_on_card = dict(ref.cuda_calls)
    steps = eng.decode_steps - steps0
    lens = [len(r.prompt) for r in reqs]
    want_steps = sum(-(-lens.count(n) // LM_MAX_BATCH) * (n + LM_MAX_NEW)
                     for n in set(lens))
    sites = lm.attention_sites(cfg) + lm.cross_sites(cfg)
    check(steps == want_steps, f"{cfg.name}: the engine made {steps} decode "
          f"steps, the run implies {want_steps}")
    check(counts["flash_decode"] == sites * steps,
          f"{cfg.name}: flash_decode launched {counts['flash_decode']} "
          f"times in {steps} decode steps of {sites} attention sites")
    check(all(v == 0 for v in plain_on_card.values()),
          f"{cfg.name}: a plain version ran on the card: {plain_on_card}")
    check(all(r.done and len(r.output) == LM_MAX_NEW
              and all(0 <= t < cfg.vocab_size for t in r.output)
              for r in reqs), f"{cfg.name}: a request is short or out of "
          "range")
    return counts, {
        "requests": stats["requests"], "tokens": stats["tokens"],
        "wall_s": stats["wall_s"], "tok_per_s": stats["tok_per_s"],
        "buckets": stats["buckets"], "decode_steps": steps,
        "attention_sites": sites, "ms_per_decode_step":
            1e3 * stats["wall_s"] / steps,
        "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        "plain_on_card": plain_on_card}


def _step_ms(step, iters=20):
    """Host ms per call of ``step`` after 3 warm-up calls, ending in a
    synchronize."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_lm(dev):
    """The LM serving path at qwen2.5-3b's full width."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get(LM_ARCH)
    # (a) float32 weights: the kernel route against the plain route.
    f32 = _route_check(dev, cfg, cfg.num_layers)
    log(f"[lm] f32, {LM_F32_BATCH} requests x {LM_F32_STEPS} steps: "
        f"tokens equal, logits max abs diff {f32['max_abs_diff']:.3g} "
        "(atol / rtol 1e-4)")

    # (b) bfloat16 weights through the engine.
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    counts, run = _engine_run(dev, cfg, model, None, LM_PROMPT_LENS,
                              LM_MAX_LEN)

    # (c) one step at the path's shape (8 requests, cache at 520): host
    # clock, profiler, and the byte bound.
    B, T = LM_MAX_BATCH, max(LM_PROMPT_LENS)
    cache = lm.init_cache(cfg, B, LM_MAX_LEN, device=dev)._replace(pos=T)
    tok = torch.zeros(B, dtype=torch.int64, device=dev)
    step = lambda: lm.decode_step(model, cfg, cache, tok)
    steady_ms = _step_ms(step)
    busy = _device_busy(step, 5)
    check(busy is not None, "the profiler trace of the LM step shows no "
          "device time")
    # The profiler slows the host; the share against the unprofiled step
    # is the one to read.
    busy["device_busy_share_unprofiled"] = (busy["device_ms_per_step"]
                                            / steady_ms)
    bound_ms, bound_by, step_bytes = _step_bound(model, cfg, B, T)
    busy["flash_decode_device_us_per_attention"] = (
        1e3 * busy["flash_decode_device_ms_per_step"] / cfg.num_layers)
    del cache
    long = _long_cache_step(model, cfg, dev)
    plain_on_card = run.pop("plain_on_card")
    timing = {
        "arch": cfg.name, "params": n_params, "dtype": cfg.compute_dtype,
        **run, "step_ms_at_T520_B8": steady_ms, "step_bound_ms": bound_ms,
        "step_bound_by": bound_by, "step_bytes": step_bytes,
        "profile": busy, "long_cache": long,
        "f32_route_max_abs_diff": f32["max_abs_diff"]}
    log(f"[lm] launches {json.dumps(counts)}; plain versions on the card "
        f"{json.dumps(plain_on_card)}; {json.dumps(timing)}")
    del model
    torch.cuda.empty_cache()
    return counts, timing


def _long_cache_step(model, cfg, dev):
    """Phase 8 (d): decode steps of B = 8 with the cache at its last
    position of ``LM_LONG_CACHE``, against the step's bound, and flash
    decode's device time from a profiler trace."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import lm

    B, T = LM_MAX_BATCH, LM_LONG_CACHE - 1
    cache = lm.init_cache(cfg, B, LM_LONG_CACHE, device=dev)._replace(pos=T)
    tok = torch.zeros(B, dtype=torch.int64, device=dev)
    step = lambda: lm.decode_step(model, cfg, cache, tok)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(5):
        logits, _ = step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / 5
    counts = ops.launch_counts()
    check(counts["flash_decode"] == 5 * cfg.num_layers
          and counts["flash_decode_combine"] == 5 * cfg.num_layers,
          f"long-cache step: flash-decode launches {counts}")
    check(bool(logits.isfinite().all()), "long-cache step: logits not "
          "finite")
    busy = _device_busy(step, 3)
    check(busy is not None, "the profiler trace of the long-cache step "
          "shows no device time")
    bound_ms, bound_by, step_bytes = _step_bound(model, cfg, B, T)
    out = {"batch": B, "cache_pos": T, "step_ms": step_ms,
           "step_bound_ms": bound_ms, "step_bound_by": bound_by,
           "step_bytes": step_bytes,
           "cache_gb": 2 * cache.attn_k.numel() * cache.attn_k.element_size()
           / 1e9,
           "flash_decode_device_ms_per_step":
               busy["flash_decode_device_ms_per_step"],
           "device_ms_per_step": busy["device_ms_per_step"],
           "device_busy_share_unprofiled": busy["device_ms_per_step"]
           / step_ms, "top_kernels": busy["top_kernels"]}
    log(f"[lm] one step at B = {B}, cache at {T}: {step_ms:.3f} ms against "
        f"a bound of {bound_ms:.3f} ms ({bound_by}); flash decode "
        f"{out['flash_decode_device_ms_per_step']:.3f} ms of device time "
        "per step")
    del cache
    torch.cuda.empty_cache()
    return out


def _moe_rows(step):
    """Per MoE layer, (experts routed to, kept rows) in one call of
    ``step``: each ``moe_ffn`` call's routing, recomputed on its input."""
    from repro_torch.models import moe

    seen, ffn = [], moe.moe_ffn

    def spy(p, cfg, x, n_groups=None, **kw):
        r = moe.route(p, cfg, x, n_groups)
        seen.append((int(r.experts[r.keep].unique().numel()),
                     int(r.keep.sum())))
        return ffn(p, cfg, x, n_groups, **kw)

    moe.moe_ffn = spy
    try:
        step()
    finally:
        moe.moe_ffn = ffn
    return seen


def _frontend_feats(cfg, dev, seed):
    """Seeded random frontend features (1, S, d) of an audio / vlm config
    in its compute dtype (the launcher's zeros would make every cross key
    equal); None for the other families."""
    import torch

    from repro_torch.models import common, lm

    if not lm.cross_sites(cfg):
        return None
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
    return torch.randn((1, S, cfg.d_model), generator=gen, device=dev).to(
        common.dtype(cfg.compute_dtype))


def phase_lm_families(dev):
    """Phase 8b: the MoE, SSM, hybrid, audio and vlm families at full
    width (``LM_FAMILIES``), one model at a time: (a) the float32 route
    check, (b) the engine in bfloat16, (c) one step at B = 8 with the
    cache at FAMILY_STEP_POS."""
    import collections
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    total, out = collections.Counter(), {}
    for arch, layers, check_layers in LM_FAMILIES:
        t0 = time.perf_counter()
        base = configs.get(arch)
        cfg = base if layers is None else dataclasses.replace(
            base, num_layers=layers)
        rec = {"family": cfg.family, "layers": cfg.num_layers,
               "published_layers": base.num_layers,
               "published_bf16_gb": 2 * sum(
                   p.numel() for p in lm.LM(base, "meta").parameters())
               / 1e9}
        rec["f32_route"] = _route_check(dev, base,
                                        check_layers or base.num_layers)

        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = lm.init_params(cfg, gen, device=dev)
        rec["params"] = sum(p.numel() for p in model.parameters())
        feats = _frontend_feats(cfg, dev, 1)
        counts, run = _engine_run(dev, cfg, model, feats,
                                  FAMILY_PROMPT_LENS, FAMILY_MAX_LEN)
        total.update(counts)
        del run["plain_on_card"]            # all 0, checked
        rec.update(run)
        rec["flash_decode_launches"] = counts["flash_decode"]

        B, T = LM_MAX_BATCH, FAMILY_STEP_POS
        cache = lm.init_cache(cfg, B, FAMILY_MAX_LEN, device=dev)._replace(
            pos=T)
        if feats is not None:
            k, v = lm.precompute_cross_kv(model, cfg,
                                          feats.expand(B, *feats.shape[1:]))
            cache = cache._replace(cross_k=k, cross_v=v)
        tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen,
                            device=dev)
        step = lambda: lm.decode_step(model, cfg, cache, tok)
        step_ms = _step_ms(step)
        busy = _device_busy(step, 5)
        check(busy is not None, f"the profiler trace of {arch}'s step shows "
              "no device time")
        rows = _moe_rows(step) if cfg.family == "moe" else None
        bound_ms, bound_by, step_bytes = _step_bound(model, cfg, B, T, rows)
        rec.update({
            "step_ms": step_ms, "step_bound_ms": bound_ms,
            "step_bound_by": bound_by, "step_bytes": step_bytes,
            "device_ms_per_step": busy["device_ms_per_step"],
            "device_busy_share_unprofiled": busy["device_ms_per_step"]
            / step_ms,
            "device_busy_share_profiled": busy["device_busy_share"],
            "flash_decode_device_ms_per_step":
                busy["flash_decode_device_ms_per_step"],
            "top_kernels": busy["top_kernels"],
            "moe_experts_routed": rows and [r[0] for r in rows],
            "seconds": time.perf_counter() - t0})
        log(f"[lm8b] {arch} ({cfg.family}, {cfg.num_layers} of "
            f"{base.num_layers} layers): f32 route {rec['f32_route']}; "
            f"{run['decode_steps']} steps, flash_decode "
            f"{counts['flash_decode']} = {run['attention_sites']} x "
            f"{run['decode_steps']}; {run['tok_per_s']:.2f} tokens/s; one "
            f"step at B = {B}, T = {T}: {step_ms:.3f} ms against a bound "
            f"of {bound_ms:.3f} ms ({bound_by}), busy "
            f"{rec['device_busy_share_unprofiled']:.3f}; {json.dumps(rec)}")
        out[arch] = rec
        del model, cache, step
        torch.cuda.empty_cache()
    return dict(total), out


def _recorded(fn):
    """``fn()`` with every ``lm.decode_step`` call's logits (whole, float32)
    and host seconds recorded: (result, logits, seconds)."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.models import lm

    logits, secs, real = [], [], lm.decode_step

    def rec(*a, **kw):
        t0 = time.perf_counter()
        out, cache = real(*a, **kw)
        full = out.full_tensor() if isinstance(out, DTensor) else out
        logits.append(full.to(torch.float32))
        secs.append(time.perf_counter() - t0)
        return out, cache

    lm.decode_step = rec
    try:
        out = fn()
    finally:
        lm.decode_step = real
    return out, logits, secs


def _serve_pair(what, plain, sharded, exact=True):
    """The unsharded and the sharded run of the same requests on the same
    weights: each a (requests, logits, seconds) of :func:`_recorded`.
    With ``exact`` the tokens must be equal and the logits within 1e-4 at
    every step; otherwise the share of equal tokens is recorded."""
    import statistics

    (r0, l0, s0), (r1, l1, s1) = plain, sharded
    check(len(l0) == len(l1) > 0, f"{what}: {len(l0)} unsharded steps, "
          f"{len(l1)} sharded")
    err = max(float((a - b).abs().max()) for a, b in zip(l0, l1))
    t0 = [t for r in r0 for t in r.output]
    t1 = [t for r in r1 for t in r.output]
    agree = sum(a == b for a, b in zip(t0, t1)) / max(1, len(t0))
    check(all(bool(x.isfinite().all()) for x in l1),
          f"{what}: sharded logits not finite")
    if exact:
        check(t0 == t1, f"{what}: the sharded tokens differ from the "
              "unsharded engine's")
        check(err <= 1e-4, f"{what}: sharded logits differ from the "
              f"unsharded engine's by {err} (atol 1e-4)")
    ms0, ms1 = (1e3 * statistics.median(s) for s in (s0, s1))
    return {"steps": len(l0), "tokens": len(t0), "max_abs_diff": err,
            "token_agreement": agree, "ms_per_step_unsharded": ms0,
            "ms_per_step_sharded": ms1, "sharded_over_unsharded": ms1 / ms0}


def _serve_cli(argv):
    """``repro_torch.launch.serve.run(argv)`` in process, its printed lines
    logged with a prefix, recorded: (requests, logits, seconds, stats)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, logits, secs = _recorded(lambda: serve.run(list(argv)))
    for line in buf.getvalue().splitlines():
        log(f"[serve_sharded]   serve: {line}")
    stats = {k: v for k, v in out.items() if k != "reqs"}
    return out["reqs"], logits, secs, stats


def _shard_combine(q, k, v, pos, m):
    """Attention of q over rows [0, pos] of k / v (B, Tmax, Hkv, D) cut into
    m contiguous virtual shards: each shard's partials (the neutral ones
    where it holds no valid row), padded to one width, side by side in
    shard order, then the combine kernel."""
    import torch

    from repro_torch.kernels import ops

    Tl = k.shape[1] // m
    parts = []
    for r in range(m):
        n = min(Tl, max(0, pos + 1 - r * Tl))
        parts.append(ops.decode_attention_partials(
            q, k[:, r * Tl:r * Tl + n], v[:, r * Tl:r * Tl + n], m, Tl))
    return ops.decode_attention_combine(torch.cat(parts, dim=2))


def _virtual_shards(dev):
    """Phase 8d (d): the virtual-shard combine against ``flash_decode`` and
    the plain version on the valid rows (within 1e-5), two calls
    bit-equal; the partials and the combine each against their plain
    versions.  Returns the worst errors."""
    import torch

    from repro_torch.kernels import flash_decode, ref

    B, Hq, Hkv, D, T = SHARD_CACHE
    q, k, v = _attn_inputs(SHARD_CACHE, torch.bfloat16, dev, 77)
    worst = {"vs_flash_decode": 0.0, "vs_plain": 0.0, "partials": 0.0,
             "combine": 0.0, "cases": 0}
    for m in SHARD_COUNTS:
        for pos in SHARD_POSITIONS:
            got = _shard_combine(q, k, v, pos, m)
            again = _shard_combine(q, k, v, pos, m)
            rows = (k[:, :pos + 1], v[:, :pos + 1])
            e1 = float((got - flash_decode.flash_decode(q, *rows)).abs()
                       .max())
            e2 = float((got - ref.flash_decode_ref(q, *rows)).abs().max())
            check(bool(got.isfinite().all()) and e1 <= 1e-5 and e2 <= 1e-5,
                  f"virtual shards m = {m}, pos = {pos}: {e1} against "
                  f"flash_decode, {e2} against the plain version (1e-5)")
            check(torch.equal(got, again), f"virtual shards m = {m}, pos = "
                  f"{pos}: two calls differ")
            worst["vs_flash_decode"] = max(worst["vs_flash_decode"], e1)
            worst["vs_plain"] = max(worst["vs_plain"], e2)
            worst["cases"] += 1
    # Each kernel against its plain version on one shard's rows.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, pos in ((2, 1023), (4, 600), (8, 100)):
        Tl = T // m
        width = flash_decode.shard_width(m, Tl)
        kk, vv = k[:, :Tl], v[:, :Tl]
        parts = flash_decode.flash_decode_partials(q, kk, vv, width)
        per = flash_decode.plan_splits(B, Hkv, Tl, sms, width)[1]
        want = ref.flash_decode_partials_ref(q, kk, vv,
                                             per * flash_decode.TILE)
        e = float((parts - want).abs().max())
        check(e <= 1e-4, f"partials at m = {m}: {e} against the plain "
              "version (1e-4)")
        worst["partials"] = max(worst["partials"], e)
        full = torch.cat([parts, parts], dim=2)
        e = float((flash_decode.flash_decode_combine(full)
                   - ref.flash_decode_combine_ref(full)).abs().max())
        check(e <= 1e-5, f"combine at m = {m}: {e} against the plain "
              "version (1e-5)")
        worst["combine"] = max(worst["combine"], e)
    return worst


def phase_serve_sharded(dev):
    """Phase 8d: sharded serving on an NCCL world of one rank (``HashStore``,
    no network): DTensor placements, ``local_map``, the partials kernel,
    a one-member all-gather and the combine kernel.  (a) qwen2.5-3b whole
    in float32 through ``serve --mesh 1x1`` in process against the
    unsharded launcher run (same seed, same weights): tokens equal, logits
    within 1e-4 at every step; its kernel launches counted (the phase's
    main path); (b) the same in bfloat16: ms a step of each, the share of
    equal tokens; (c) phi3.5-MoE and zamba2-1.2b in float32 through
    ``Engine`` (the MoE and Mamba sites sharded), the same check as (a);
    (d) virtual shards of one cache."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm
    from repro_torch.serving import Engine, ServeConfig, synthetic_requests

    out = {}
    f32 = SERVE_SHARDED_ARGS + ("--f32",)
    # The unsharded launcher runs first: inside a world, --mesh 1x1 is the
    # world's mesh.
    plain, plain_bf16 = _serve_cli(f32), _serve_cli(SERVE_SHARDED_BF16_ARGS)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        sharded = _serve_cli(f32 + ("--mesh", "1x1"))
        torch.cuda.synchronize()
        counts, plain_on_card = ops.launch_counts(), dict(ref.cuda_calls)
        cfg = configs.get(LM_ARCH)
        steps = len(sharded[1])
        sites = lm.attention_sites(cfg)
        check(counts["flash_decode_partials"] == sites * steps
              and counts["flash_decode_combine"] == sites * steps
              and counts["flash_decode"] == 0,
              f"sharded serving launched {counts} in {steps} steps of "
              f"{sites} attention sites")
        check(all(v == 0 for v in plain_on_card.values()),
              f"sharded serving: a plain version ran on the card: "
              f"{plain_on_card}")
        rec = _serve_pair("qwen2.5-3b f32 sharded", plain[:3], sharded[:3])
        rec["stats"] = sharded[3]
        out["qwen_f32"] = rec
        log(f"[serve_sharded] (a) {LM_ARCH} f32, serve --mesh 1x1: tokens "
            f"equal, logits max abs diff {rec['max_abs_diff']:.3g} over "
            f"{steps} steps; launches {json.dumps(counts)}; "
            f"{json.dumps(rec)}")
        del plain, sharded
        torch.cuda.empty_cache()

        sharded = _serve_cli(SERVE_SHARDED_BF16_ARGS + ("--mesh", "1x1"))
        rec = _serve_pair("qwen2.5-3b bf16 sharded", plain_bf16[:3],
                          sharded[:3], exact=False)
        out["qwen_bf16"] = rec
        log(f"[serve_sharded] (b) {LM_ARCH} bf16: ms a step sharded "
            f"{rec['ms_per_step_sharded']:.2f} against unsharded "
            f"{rec['ms_per_step_unsharded']:.2f}; tokens equal "
            f"{rec['token_agreement']:.4f}; {json.dumps(rec)}")
        del plain_bf16, sharded
        torch.cuda.empty_cache()

        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cuda")
        n_req, plens, new = SERVE_SHARDED_FAMILY_RUN
        for arch, layers in SERVE_SHARDED_FAMILIES:
            base = configs.get(arch)
            cfg = dataclasses.replace(
                base, num_layers=layers or base.num_layers,
                param_dtype="float32", compute_dtype="float32")
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            model = lm.init_params(cfg, gen, device=dev)
            scfg = ServeConfig(max_len=1024, max_batch=8)

            def run(pol=None):
                reqs = synthetic_requests(n_req, cfg.vocab_size,
                                          prompt_lens=plens, max_new=new,
                                          seed=0)
                eng = Engine(cfg, model, scfg, pol=pol)
                _, logits, secs = _recorded(lambda: eng.serve(reqs))
                return reqs, logits, secs

            first = run()
            sharding.distribute_model(model, mesh, "tp")
            pol = sharding.make_policy(mesh, batch=8, kind="decode")
            rec = _serve_pair(f"{arch} f32 sharded", first, run(pol))
            rec["layers"] = cfg.num_layers
            out[arch] = rec
            log(f"[serve_sharded] (c) {arch} ({cfg.family}, "
                f"{cfg.num_layers} layers) f32: tokens equal, logits max "
                f"abs diff {rec['max_abs_diff']:.3g}; {json.dumps(rec)}")
            del model, first
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    out["virtual_shards"] = _virtual_shards(dev)
    log(f"[serve_sharded] (d) virtual shards of {SHARD_CACHE} bf16, m in "
        f"{SHARD_COUNTS}, pos in {SHARD_POSITIONS}: "
        f"{json.dumps(out['virtual_shards'])} (1e-5; two calls bit-equal)")
    return counts, out


def _sdpa_partial(q, k, v):
    """One PyTorch call that computes the partial of a cache slice: the
    memory-efficient SDPA kernel with its log-sum-exp, q viewed as (B,
    Hkv, G, D).  Returns (out (B, Hq, D), lse (B, Hq)) float32, the
    partial (acc = out, m = lse, l = 1)."""
    import torch

    B, Hq, D = q.shape
    Hkv = k.shape[2]
    out, lse = torch.ops.aten._scaled_dot_product_efficient_attention(
        q.view(B, Hkv, Hq // Hkv, D), k.transpose(1, 2), v.transpose(1, 2),
        None, True)[:2]
    return (out.reshape(B, Hq, D).float(),
            lse[..., :Hq // Hkv].reshape(B, Hq))


def _shard_entries(dev, counts, errs):
    """The kernel lines of the partials and combine entries: ms, plain
    and library ms, device µs a launch from a trace, and the bound at
    each shape of ``SHARD_TIMED`` (the first, phase 8d (a)'s, gives the
    line's numbers); launches from phase 8d's sharded serve run.  The
    partials' bound reads q and the slice's valid rows and writes one
    partial a query row (the split count is the plan's choice); the
    combine's reads the rank-padded partials it is given."""
    import torch

    from repro_torch.kernels import flash_decode, ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape = {"partials": {}, "combine": {}}
    worst = {"partials": 0.0, "combine": 0.0, "library": 0.0}
    for i, ((B, Hq, Hkv, D, T), m, n, dt_name) in enumerate(SHARD_TIMED):
        dt = getattr(torch, dt_name)
        el = torch.finfo(dt).bits // 8
        width = flash_decode.shard_width(m, T // m)
        S, per = flash_decode.plan_splits(B, Hkv, n, sms, width)
        p_bytes = el * (B * Hq * D + 2 * B * n * Hkv * D) + 4 * B * Hq * (
            D + 2)
        copies = max(1, -(-120_000_000 // p_bytes))
        sets = [_attn_inputs((B, Hq, Hkv, D, n), dt, dev, 500 + 1000 * i + c)
                for c in range(copies)]
        partials = lambda q, k, v: flash_decode.flash_decode_partials(
            q, k, v, width)
        plain = lambda q, k, v: ref.flash_decode_partials_ref(
            q, k, v, per * flash_decode.TILE)
        # Each rank's partials padded to the shared width, m ranks' side
        # by side: what the combine gets on the main path.
        padded = lambda q, k, v: torch.cat([
            partials(q, k, v), ref.neutral_partials(
                B, Hq, width - S, D, dev)] * m, dim=2)
        q, k, v = sets[0]
        got, want = partials(q, k, v), plain(q, k, v)
        check(got.shape[2] == S, f"partials at {(B, Hq, Hkv, D, n)}: "
              f"{got.shape[2]} splits, the plan says {S}")
        e_p = float((got - want).abs().max())
        parts = padded(q, k, v)
        c_sets = [(padded(*a),) for a in sets]
        combined = flash_decode.flash_decode_combine(parts)
        e_c = float((combined - ref.flash_decode_combine_ref(parts))
                    .abs().max())
        lib_out, lib_lse = _sdpa_partial(q, k, v)
        M = got[..., D].amax(dim=-1)
        lse = M + torch.log((got[..., D + 1] * torch.exp(
            got[..., D] - M[..., None])).sum(dim=-1))
        e_lib = max(float((lib_out - flash_decode.flash_decode_combine(got))
                          .abs().max()),
                    float((lib_lse - lse).abs().max()))
        check(e_p <= 1e-4 and e_c <= 1e-5 and e_lib <= 1e-2,
              f"shard kernels at {(B, Hq, Hkv, D, n)} {dt_name}: partials "
              f"{e_p} (1e-4), combine {e_c} (1e-5) against their plain "
              f"versions; the efficient SDPA's partial {e_lib} (1e-2)")
        worst["partials"] = max(worst["partials"], e_p)
        worst["combine"] = max(worst["combine"], e_c)
        worst["library"] = max(worst["library"], e_lib)
        p_bound, p_by = _bound(p_bytes, 4 * B * Hq * n * D + 5 * B * Hq * n)
        Sc = parts.shape[2]
        c_bound, c_by = _bound(4 * (B * Hq * Sc * (D + 2) + B * Hq * D),
                               B * Hq * Sc * (2 * D + 3))
        # Device µs a launch from a profiler trace of back-to-back calls:
        # the CUDA-event ms of a wrapper this short may read the host's
        # enqueue.
        dev_us = {}
        for name, fn, kernel in (
                ("partials", lambda: partials(q, k, v), "split_kernel"),
                ("combine", lambda: flash_decode.flash_decode_combine(parts),
                 "combine_kernel")):
            trace = _kernel_trace(fn, SEARCH_TRACE_CALLS)
            check(trace is not None, f"the profiler trace of the {name} "
                  "kernel shows no device time")
            dev_us[name] = sum(r[1] for r in trace["kernels"]
                               if kernel in r[0])
        key = f"{[B, Hq, Hkv, D, T]} m={m} rows={n} {dt_name}"
        by_shape["partials"][key] = {
            "shape": [B, Hq, Hkv, D, n], "dtype": dt_name, "splits": S,
            "width": width, "max_abs_err": e_p,
            "ms": time_ms_cycle(partials, sets, 500),
            "device_us_per_launch": dev_us["partials"],
            "plain_ms": time_ms_cycle(plain, sets, 100),
            "library_ms": time_ms_cycle(_sdpa_partial, sets, 500),
            "library_max_abs_diff": e_lib,
            "bound_ms": p_bound, "bound_by": p_by}
        by_shape["combine"][key] = {
            "shape": list(parts.shape), "dtype": "float32",
            "max_abs_err": e_c,
            "ms": time_ms_cycle(flash_decode.flash_decode_combine, c_sets,
                                500),
            "device_us_per_launch": dev_us["combine"],
            "plain_ms": time_ms_cycle(ref.flash_decode_combine_ref, c_sets,
                                      100),
            "library_ms": None, "bound_ms": c_bound, "bound_by": c_by}
        del sets, c_sets
        torch.cuda.empty_cache()
    errs = errs or {}
    common = {"route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
              "replaces": "src/repro/kernels/flash_decode.py:66",
              "tpu_kernel": "repro/kernels/flash_decode.py::"
                            "flash_decode_padded"}
    entries = []
    for name, library in (
            ("partials", "torch.ops.aten._scaled_dot_product_efficient_"
                         "attention(compute_log_sumexp=True)"),
            ("combine", None)):
        rows = by_shape[name]
        main = next(iter(rows.values()))
        entries.append({
            "name": f"flash_decode_{name}", **common, **main,
            "launches": counts[f"flash_decode_{name}"],
            "max_abs_err": max(worst[name], errs.get(name, 0.0)),
            "library": library, "by_shape": rows})
    return entries


def _aux_feats(cfg, B, dev, seed):
    """Seeded random frontend stubs of an audio / vlm config in its compute
    dtype, as ``forward_hidden`` takes them ({"frames"} / {"patches"}, B
    rows); None for the other families."""
    feats = _frontend_feats(cfg, dev, seed)
    if feats is None:
        return None
    key = "frames" if cfg.family == "audio" else "patches"
    return {key: feats.expand(B, *feats.shape[1:]).contiguous()}


def _prefill_vs_decode(dev, base, layers, T):
    """Float32 weights at ``layers`` layers of ``base`` (MoE at capacity
    factor 8, where neither path drops a token): the prefill's logits of
    a prompt of T tokens against the last logits of T teacher-forced
    decode steps (flash decode on the card), atol / rtol 1e-4."""
    import dataclasses

    import torch

    from repro_torch.models import lm

    cfg = dataclasses.replace(base, num_layers=layers,
                              param_dtype="float32", compute_dtype="float32")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, moe_capacity_factor=8.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    model = lm.init_params(cfg, gen, device=dev)
    B = PREFILL_CHECK_BATCH
    tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                           device=dev)
    aux = _aux_feats(cfg, B, dev, 3)
    last = lm.prefill(model, cfg, tokens, aux)
    cache = lm.init_cache(cfg, B, T, device=dev)
    if aux is not None:
        with torch.no_grad():
            feats = (lm._encode_audio(model, cfg, aux["frames"])
                     if cfg.family == "audio" else aux["patches"])
        k, v = lm.precompute_cross_kv(model, cfg, feats)
        cache = cache._replace(cross_k=k, cross_v=v)
    for t in range(T):
        logits, cache = lm.decode_step(model, cfg, cache, tokens[:, t])
    torch.cuda.synchronize()
    err = float((last - logits).abs().max())
    check(bool(last.isfinite().all()), f"{base.name} prefill logits not "
          "finite")
    check(torch.allclose(last, logits, rtol=1e-4, atol=1e-4),
          f"{base.name} f32 at {layers} layers, T = {T}: prefill differs "
          f"from the teacher-forced decode by {err}")
    del model, cache
    torch.cuda.empty_cache()
    return {"layers": layers, "T": T, "max_abs_diff": err}


def _prefill_bound(model, cfg, B, T, moe_rows):
    """The least time (ms) and its limit for one prefill of B x T tokens,
    with its FLOPs and bytes.  FLOPs: 2 per weight element and row of
    each matrix product (the embedding is a gather; the unembedding and a
    tied table multiply only the last position; the audio encoder's
    weights B x S frames; cross wk / wv the B x S features; hybrid's
    shared block at each site; of an MoE layer's experts the kept rows of
    ``moe_rows``), the attentions' score and value products (causal: the
    half on or below the diagonal), and SSD's products within and across
    chunks.  Bytes: every weight read once, tokens in and logits out.  At
    the bf16 tensor-core rate."""
    from repro_torch.models import lm, ssm

    S = cfg.encoder_seq if cfg.family == "audio" else cfg.vision_seq
    hd, H = cfg.hd(), cfg.num_heads
    nbytes = ops = 0
    for name, p in model.named_parameters():
        parts = ["", *name.split(".")]
        nbytes += p.numel() * p.element_size()
        if name == "embed.tok":
            if cfg.tie_embeddings:
                ops += 2 * B * p.numel()
            continue
        if name == "embed.unembed":
            ops += 2 * B * p.numel()
            continue
        if parts[-2] == "moe" and parts[-1] != "router":
            ops += 2 * moe_rows[int(parts[2])][1] * p.numel() / (
                cfg.num_experts)
            continue
        if p.dim() < 2 or parts[-1] == "conv_w":
            continue
        if parts[1] == "encoder" or (parts[-2] == "xattn"
                                     and parts[-1] in ("wk", "wv")):
            rows = B * S
        else:
            rows = B * T
        sites = lm.attention_sites(cfg) if parts[1] == "shared_attn" else 1
        ops += 2 * rows * p.numel() * sites
    ops += 2 * B * H * hd * T * T * lm.attention_sites(cfg)
    ops += 4 * B * H * hd * T * S * lm.cross_sites(cfg)
    if cfg.family == "audio":
        ops += 4 * B * H * hd * S * S * cfg.encoder_layers
    if lm.mamba_layers(cfg):
        d_inner, Hs, P, N = ssm.dims(cfg)
        Q = min(cfg.ssm_chunk, T)
        per = B * T * (Q * (N + Hs * P) + 4 * Hs * P * N)
        ops += per * lm.mamba_layers(cfg)
    nbytes += 8 * B * T + B * cfg.vocab_size * model.embed.tok.element_size()
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", ops, nbytes)


def _blockwise_checks(dev):
    """The blockwise path against the direct one at ``BLOCKWISE_SHAPES``
    (float32, atol / rtol 1e-4): the online softmax over chunks of 1,024
    keys, and its ragged tail at S = 1,500 and 1,601."""
    import torch

    from repro_torch.models import common

    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    out = {}
    for name, B, T, S, Hq, Hkv, hd, causal in BLOCKWISE_SHAPES:
        q = torch.randn((B, T, Hq, hd), generator=gen, device=dev)
        k, v = (torch.randn((B, S, Hkv, hd), generator=gen, device=dev)
                for _ in range(2))
        with torch.no_grad():
            got = common.blockwise_attention(q, k, v, causal=causal)
            want = common._direct_attention(q, k, v, torch.float32, causal)
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"blockwise attention {name} differs from the direct path by "
              f"{err}")
        out[name] = err
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def phase_prefill(dev):
    """Phase 8c: prefill of every family at full width, its float32
    checks against the teacher-forced decode, and the blockwise path
    against the direct one."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm

    # Peaks are read above what earlier phases left allocated.
    mem0 = torch.cuda.memory_allocated(dev)
    out = {"blockwise_vs_direct_max_abs_diff": _blockwise_checks(dev),
           "base_gb": mem0 / 1e9}
    log(f"[prefill] blockwise vs direct (f32, atol / rtol 1e-4): "
        f"{json.dumps(out['blockwise_vs_direct_max_abs_diff'])}")
    base = configs.get(LM_ARCH)
    out["long_check"] = _prefill_vs_decode(dev, base, 2,
                                           PREFILL_CHECK_LONG_T)
    log(f"[prefill] {LM_ARCH} f32: prefill of {PREFILL_CHECK_LONG_T} tokens "
        f"(blockwise) against {PREFILL_CHECK_LONG_T} decode steps "
        f"{json.dumps(out['long_check'])}")
    for arch, layers, check_layers in ((LM_ARCH, None, 2),) + LM_FAMILIES:
        t0 = time.perf_counter()
        base = configs.get(arch)
        cfg = base if layers is None else dataclasses.replace(
            base, num_layers=layers)
        rec = {"family": cfg.family, "layers": cfg.num_layers,
               "published_layers": base.num_layers,
               "f32_check": _prefill_vs_decode(
                   dev, base, check_layers or base.num_layers,
                   PREFILL_CHECK_T)}
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = lm.init_params(cfg, gen, device=dev)
        B = PREFILL_BATCH
        aux = _aux_feats(cfg, B, dev, 1)
        for T in PREFILL_LENS:
            tokens = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                   device=dev)
            run = lambda: lm.prefill(model, cfg, tokens, aux)
            last = run()                                    # warm-up
            check(tuple(last.shape) == (B, cfg.vocab_size)
                  and bool(last.isfinite().all()),
                  f"{arch} prefill at T = {T}: shape {tuple(last.shape)} "
                  "or values not finite")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t1 = time.perf_counter()
            for _ in range(PREFILL_TIMED):
                run()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t1) / PREFILL_TIMED
            peak = (torch.cuda.max_memory_allocated(dev) - mem0) / 1e9
            rows = _moe_rows(run) if cfg.family == "moe" else None
            bound_ms, bound_by, flops, nbytes = _prefill_bound(
                model, cfg, B, T, rows)
            rec[f"T{T}"] = {
                "ms": ms, "peak_gb": peak, "bound_ms": bound_ms,
                "bound_by": bound_by, "flops": flops, "bytes": nbytes,
                "share_of_bf16_peak": flops / (1e-3 * ms) / BF16_FLOP_PER_S,
                "tokens_per_s": B * T / (1e-3 * ms)}
            log(f"[prefill] {arch} ({cfg.family}, {cfg.num_layers} of "
                f"{base.num_layers} layers) B = {B}, T = {T}: {ms:.2f} ms a "
                f"prefill, peak {peak:.2f} GB, bound {bound_ms:.3f} ms "
                f"({bound_by}; {flops:.3g} FLOPs), "
                f"{100 * rec[f'T{T}']['share_of_bf16_peak']:.1f}% of the "
                "bf16 peak")
            if arch == LM_ARCH:
                rec[f"T{T}"]["trace"] = _device_busy(run, 1, top=8)
                log(f"[prefill] {arch} T = {T} trace: "
                    f"{json.dumps(rec[f'T{T}']['trace'])}")
            del tokens, last, run
        rec["seconds"] = time.perf_counter() - t0
        log(f"[prefill] {arch}: f32 check {json.dumps(rec['f32_check'])}")
        out[arch] = rec
        del model, aux
        torch.cuda.empty_cache()
    return out


def _train_flops(cfg, B, T):
    """Model FLOPs of one training step: 6 per weight element a token of
    the matrix products (the embedding gather excluded, the unembedding
    included) plus 3x the causal attention's score and value products;
    remat's recomputation not counted."""
    from repro_torch.models import lm

    model = lm.LM(cfg, "meta")
    n = sum(p.numel() for name, p in model.named_parameters()
            if p.dim() == 2 and name != "embed.tok")
    if cfg.tie_embeddings:
        n += model.embed.tok.numel()
    attn = 2 * B * cfg.num_heads * cfg.hd() * T * T * cfg.num_layers
    return 6 * n * B * T + 3 * attn


def _deterministic():
    """A context that turns on ``torch.use_deterministic_algorithms(True,
    warn_only=True)`` and yields the list of warnings raised inside it
    (an operation without a deterministic implementation warns)."""
    import contextlib
    import warnings

    import torch

    @contextlib.contextmanager
    def ctx():
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                yield caught
        finally:
            torch.use_deterministic_algorithms(prev)

    return ctx()


def _nondeterministic(caught):
    return sorted({str(w.message).split(".")[0][:160] for w in caught
                   if "determinis" in str(w.message)})


def _family_train_steps(dev):
    """One bfloat16 ``lm.train_step`` of each other family at a smoke size
    (float32 master weights, the launcher's optimizer): the backward
    through MoE, SSD, the shared block, cross-attention and the audio
    encoder on the card; loss and every parameter finite.  Each step runs
    twice from the same seed with deterministic algorithms off (are the
    parameters bit-equal?) and once more with them on, recording the
    operations that warn of having no deterministic implementation."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.training import data, optim

    def one_step(cfg):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = lm.init_params(cfg, gen, device=dev, dtype=torch.float32)
        opt = optim.Adam(lr=optim.cosine_schedule(3e-4, 1, 10),
                         weight_decay=0.01, clip_norm=1.0)
        state = opt.init(dict(model.named_parameters()))
        B, T = TRAIN_SMOKE_BATCH, TRAIN_SMOKE_T
        batch = data.device_batch(data.SyntheticLM(data.DataConfig(
            seq_len=T, global_batch=B, vocab_size=cfg.vocab_size)).batch(0),
            dev)
        batch.update(_aux_feats(cfg, B, dev, 5) or {})
        t0 = time.perf_counter()
        model, state, loss = lm.train_step(model, state, batch, cfg, opt)
        torch.cuda.synchronize()
        return (float(loss), [p.detach().clone() for p in
                              model.parameters()],
                1e3 * (time.perf_counter() - t0))

    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  compute_dtype="bfloat16")
        loss, params, ms = one_step(cfg)
        check(math.isfinite(loss) and all(bool(p.isfinite().all())
                                          for p in params),
              f"{arch}: a smoke training step gave a loss {loss} or "
              "parameters that are not finite")
        loss2, params2, _ = one_step(cfg)
        with _deterministic() as caught:
            one_step(cfg)
        out[arch] = {
            "loss": loss, "first_step_ms": ms,
            "repeat_bit_equal": loss == loss2 and all(
                torch.equal(a, b) for a, b in zip(params, params2)),
            "nondeterministic_warnings": _nondeterministic(caught)}
        del params, params2
    torch.cuda.empty_cache()
    log(f"[train] one bf16 smoke step of each other family: "
        f"{json.dumps(out)}")
    return out


def _train_trace(dev, cfg, B, T):
    """A profiler trace of 2 of the launcher's bf16 steps (after 2
    warm-up steps) at full width: device ms and busy share a step and the
    kernels that took most."""
    import torch

    from repro_torch.models import lm
    from repro_torch.training import data, optim

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = lm.init_params(cfg, gen, device=dev, dtype=torch.float32)
    opt = optim.Adam(lr=optim.cosine_schedule(3e-4, 20, TRAIN_STEPS),
                     weight_decay=0.01, clip_norm=1.0)
    state = opt.init(dict(model.named_parameters()))
    batch = data.device_batch(data.SyntheticLM(data.DataConfig(
        seq_len=T, global_batch=B, vocab_size=cfg.vocab_size)).batch(0),
        dev)

    def step():
        nonlocal model, state
        model, state, loss = lm.train_step(model, state, batch, cfg, opt)
        return float(loss)

    for _ in range(2):
        step()
    trace = _device_busy(step, 2, top=10)
    check(trace is not None, "the trace of the training step shows no "
          "device time")
    log(f"[train] trace of 2 steps: {json.dumps(trace)}")
    del model, state
    torch.cuda.empty_cache()
    return trace


def phase_train(dev):
    """Phase 10: the launcher's training of qwen1.5-0.5b at full width,
    its resume from step 20, a --micro 2 step, and one smoke-size step of
    each other family."""
    import os
    import shutil
    import statistics
    import tempfile

    import torch

    from repro_torch import configs
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.training import checkpoint

    ckdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    argv = ["--arch", TRAIN_ARCH, *TRAIN_ARGS, "--device", dev.type,
            "--ckpt-dir", ckdir, "--ckpt-every", str(TRAIN_RESUME_AT)]

    def keep_only(step):
        for d in os.listdir(ckdir):
            if d != f"step_{step:010d}":
                shutil.rmtree(os.path.join(ckdir, d))
        check(checkpoint.latest_step(ckdir) == step,
              f"checkpoint of step {step} missing")

    mem0 = torch.cuda.memory_allocated(dev)     # earlier phases' leftovers
    try:
        with _deterministic() as caught:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            full = train.run(argv + ["--steps", str(TRAIN_STEPS)])
            wall = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated(dev) - mem0) / 1e9
            keep_only(TRAIN_RESUME_AT)
            micro = train.run(argv + ["--steps", str(TRAIN_RESUME_AT + 1),
                                      "--resume", "--micro", "2"])
            keep_only(TRAIN_RESUME_AT)
            resumed = train.run(argv + ["--steps", str(TRAIN_STEPS),
                                        "--resume"])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    nondeterministic = _nondeterministic(caught)
    losses = full["losses"]
    check(full["steps_run"] == TRAIN_STEPS and all(
        math.isfinite(x) for x in losses), f"training ran "
          f"{full['steps_run']} steps, losses {losses}")
    check(full["final_loss"] < full["first_loss"], f"the loss did not "
          f"fall: first {full['first_loss']}, final {full['final_loss']}")
    tail = losses[TRAIN_RESUME_AT:]
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed["losses"], tail))
    bit_equal = resumed["losses"] == tail
    check(resumed["steps_run"] == len(tail) and rel <= TRAIN_RESUME_RTOL,
          f"the resumed run's losses {resumed['losses']} differ from the "
          f"uninterrupted run's {tail} by {rel} relative")
    micro_rel = abs(micro["losses"][0] - tail[0]) / abs(tail[0])
    check(micro["steps_run"] == 1 and micro_rel <= TRAIN_MICRO_RTOL,
          f"the --micro 2 step's loss {micro['losses']} differs from the "
          f"full batch's {tail[0]} by {micro_rel} relative")
    cfg = configs.get(TRAIN_ARCH)
    B, T = int(TRAIN_ARGS[1]), int(TRAIN_ARGS[3])
    step_ms = 1e3 * statistics.median(full["step_s"][5:])
    flops = _train_flops(cfg, B, T)
    rec = {
        "arch": TRAIN_ARCH, "batch": B, "seq": T, "steps": TRAIN_STEPS,
        "params": sum(p.numel() for p in lm.LM(cfg, "meta").parameters()),
        "ms_per_step_median": step_ms,
        "first_step_ms": 1e3 * full["step_s"][0],
        "tokens_per_s": B * T / (1e-3 * step_ms), "peak_gb": peak,
        "base_gb": mem0 / 1e9,
        "wall_s": wall, "first_loss_mean": full["first_loss"],
        "final_loss_mean": full["final_loss"], "model_flops": flops,
        "share_of_bf16_peak": flops / (1e-3 * step_ms) / BF16_FLOP_PER_S,
        "resume_bit_equal": bit_equal, "resume_max_rel_diff": rel,
        "micro2_rel_diff": micro_rel, "micro2_step_ms":
            1e3 * micro["step_s"][0],
        "nondeterministic_warnings": nondeterministic,
        "losses": losses, "resumed_losses": resumed["losses"]}
    log(f"[train] {TRAIN_ARCH} B = {B}, T = {T}, bf16: {step_ms:.2f} ms a "
        f"step (median of steps 6-{TRAIN_STEPS}), "
        f"{rec['tokens_per_s']:,.0f} tokens/s, peak {peak:.2f} GB, "
        f"{100 * rec['share_of_bf16_peak']:.1f}% of the bf16 dense peak "
        f"({flops:.3g} model FLOPs a step); loss {full['first_loss']:.4f} "
        f"-> {full['final_loss']:.4f}; resume from step {TRAIN_RESUME_AT}: "
        f"bit-equal {bit_equal}, max rel diff {rel:.3g}; --micro 2 rel diff "
        f"{micro_rel:.3g}; nondeterministic ops {nondeterministic}")
    rec["trace"] = _train_trace(dev, cfg, B, T)
    rec["families"] = _family_train_steps(dev)
    return rec


def _state_copy(tensors):
    """Whole copies of a dict of (possibly DTensor) tensors."""
    from torch.distributed.tensor import DTensor
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach()
            .clone() for k, v in tensors.items()}


def _rel_norm(a, b):
    """||a - b|| / ||b|| over all the tensors of two dicts, in float64."""
    num = sum(float((a[k].double() - b[k].double()).square().sum())
              for k in b)
    den = sum(float(b[k].double().square().sum()) for k in b)
    return math.sqrt(num / den)


def _sharded_case(make, step, timed=SHARDED_TIMED):
    """One case of phase 10b: ``make()`` gives (model, opt state, batch);
    the first ``step`` is the compared one (its loss, parameters and
    first moments kept whole), then ``timed`` more steps give the ms a
    step (each ends in the loss's read-back).  Peak GB above what was
    allocated before the case."""
    import statistics

    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model, state, batch = make()
    ms, kept = [], None
    for i in range(1 + timed):
        t0 = time.perf_counter()
        model, state, loss = step(model, state, batch)
        loss = float(loss)
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            peak = torch.cuda.max_memory_allocated() - base
            kept = (loss, _state_copy(dict(model.named_parameters())),
                    _state_copy(_moments(state)))
            copies = _nbytes(kept[1]) + _nbytes(kept[2])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    # The kept copies are not the case's own: the timed steps' peak
    # without them.
    peak = max(peak, torch.cuda.max_memory_allocated() - base - copies) / 1e9
    del model, state, batch
    torch.cuda.empty_cache()
    return {"loss": kept[0], "first_step_ms": ms[0],
            "ms_per_step": statistics.median(ms[1:]),
            "peak_gb": peak}, kept[1], kept[2]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors.values())


def _moments(state):
    """First moments by parameter name: an ``OptState``'s, or a
    pipeline's pair (blocks, embedding) merged."""
    if isinstance(state, tuple) and not hasattr(state, "_fields"):
        return {k: v for o in state for k, v in o.mu.items()}
    return state.mu


def _compare_case(name, rec, params, mu, ref):
    """Holds a case's step to the unsharded one: loss within
    TRAIN_RESUME_RTOL, first moments (0.1 x the clipped gradient) within
    SHARDED_REL_TOL of the unsharded ones' norm; records the largest
    parameter difference and whether parameters and moments are bit-equal."""
    import torch

    ref_loss, ref_params, ref_mu = ref
    rec["loss_rel_diff"] = abs(rec["loss"] - ref_loss) / abs(ref_loss)
    rec["mu_rel_diff"] = _rel_norm(mu, ref_mu)
    rec["param_max_abs_diff"] = max(
        float((params[k] - ref_params[k]).abs().max()) for k in ref_params)
    rec["bit_equal"] = all(torch.equal(params[k], ref_params[k])
                           and torch.equal(mu[k], ref_mu[k])
                           for k in ref_params)
    check(set(params) == set(ref_params),
          f"{name}: parameters {sorted(set(params) ^ set(ref_params))[:4]} "
          "differ from the unsharded model's")
    check(rec["loss_rel_diff"] <= TRAIN_RESUME_RTOL
          and rec["mu_rel_diff"] <= SHARDED_REL_TOL,
          f"{name}: the step's loss {rec['loss']} / first moments differ "
          f"from the unsharded step's ({ref_loss}): loss rel "
          f"{rec['loss_rel_diff']:.3g}, moments rel {rec['mu_rel_diff']:.3g}")
    return rec


TWO_RANK_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[3])
import chip_smoke
chip_smoke._two_rank_worker(int(sys.argv[1]), sys.argv[2])
"""


def _two_rank_worker(rank, store):
    """A rank of phase 10b's two-rank world on card 0: the (1, 2) tp step
    of the phase's model, then (rank 0) the unsharded step from the same
    numbers; prints one JSON line."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    try:
        dist.init_process_group("nccl", store=dist.FileStore(store, 2),
                                rank=rank, world_size=2, device_id=dev)
        probe = torch.ones(1, device=dev)
        dist.all_reduce(probe)
        torch.cuda.synchronize()
        up = float(probe) == 2.0
    except Exception as e:                     # NCCL refused the world
        print(json.dumps({"rank": rank, "up": False,
                          "error": f"{type(e).__name__}: {e}"[:600]}),
              flush=True)
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    try:
        from repro_torch.distributed import sharding
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import lm
        cfg, opt, init, batch = _sharded_setup(dev)
        mesh = mesh_lib.make_debug_mesh(1, 2, device_type="cuda")

        def make():
            model = lm.LM(cfg, device=dev, dtype=torch.float32)
            model.load_state_dict(init)
            state = opt.init(dict(model.named_parameters()))
            sharding.distribute_model(model, mesh, "tp")
            state = sharding.distribute_opt_state(state, model)
            return model, state, sharding.place_batch(batch, mesh)

        pol = sharding.make_policy(mesh, batch=batch["tokens"].shape[0])
        rec, params, mu = _sharded_case(
            make, lambda m, s, b: lm.train_step(m, s, b, cfg, opt, pol=pol),
            timed=1)
        out = {"rank": rank, "up": up, **rec}
        if rank == 0:
            ref = _unsharded_ref(cfg, opt, init, batch, dev)
            out = _compare_case("tp on (1, 2)", out, params, mu, ref)
    except Exception as e:           # a failure after the world came up
        out = {"rank": rank, "up": True,
               "failed": f"{type(e).__name__}: {e}"[:600]}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)


def _sharded_setup(dev):
    """Phase 10b's model (qwen1.5-0.5b whole, bf16 compute), optimizer
    (the launcher's), float32 initial weights from seed 0 and batch."""
    import torch

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.training import data, optim

    cfg = configs.get(TRAIN_ARCH)
    B, T = int(TRAIN_ARGS[1]), int(TRAIN_ARGS[3])
    opt = optim.Adam(lr=optim.cosine_schedule(3e-4, 20, TRAIN_STEPS),
                     weight_decay=0.01, clip_norm=1.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    init = {k: v.detach().clone() for k, v in lm.init_params(
        cfg, gen, device=dev, dtype=torch.float32).state_dict().items()}
    batch = data.device_batch(data.SyntheticLM(data.DataConfig(
        seq_len=T, global_batch=B, vocab_size=cfg.vocab_size)).batch(0),
        dev)
    return cfg, opt, init, batch


def _unsharded_ref(cfg, opt, init, batch, dev, remat=True):
    """The unsharded step from ``init``: (loss, params, first moments)."""
    import torch

    from repro_torch.models import lm

    model = lm.LM(cfg, device=dev, dtype=torch.float32)
    model.load_state_dict(init)
    state = opt.init(dict(model.named_parameters()))
    model, state, loss = lm.train_step(model, state, batch, cfg, opt,
                                       remat=remat)
    return (float(loss), _state_copy(dict(model.named_parameters())),
            _state_copy(state.mu))


def _two_ranks_on_one_card():
    """Two NCCL ranks on card 0: whether the world comes up, and if it
    does, the (1, 2) tp step against the unsharded one."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip_smoke_2r_") as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-c", TWO_RANK_WORKER, str(r),
             str(Path(tmp) / "store"), str(ROOT)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        outs, timed_out = [], False
        for p in procs:
            try:
                outs.append(p.communicate(timeout=TWO_RANK_TIMEOUT_S))
            except subprocess.TimeoutExpired:
                timed_out = True
                p.kill()
                outs.append(p.communicate())
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = []
    for so, se in outs:
        js = [ln for ln in so.splitlines() if ln.startswith("{")]
        lines.append(json.loads(js[-1]) if js else
                     {"up": False, "error": se.strip()[-600:]})
    out = {"timed_out": timed_out, "ranks": lines,
           "returncodes": [p.returncode for p in procs]}
    if any(r.get("up") for r in lines):
        check(all(r.get("up") and "failed" not in r for r in lines)
              and all(p.returncode == 0 for p in procs) and not timed_out
              and "mu_rel_diff" in lines[0],
              f"two ranks on one card came up but failed: {out}")
        out["outcome"] = "up: the (1, 2) tp step ran and agrees"
    else:
        out["outcome"] = "refused: " + "; ".join(
            str(r.get("error", "")) for r in lines if not r.get("up"))[:600]
    log(f"[train_sharded] two ranks on one card: {json.dumps(out)}")
    return out


def phase_train_sharded(dev):
    """Phase 10b: sharded training of qwen1.5-0.5b at full width (B = 8, T
    = 1,024, bf16 compute on f32 master weights) on a one-rank NCCL world
    (``HashStore``, no network): one step under tp, fsdp and dp and the
    pipeline at S = 1, M = ``PP_MICRO``, each against the unsharded step
    from the same numbers; remat none / full / dots; ms a step and peak
    GB of every case; then two ranks on the one card."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import pipeline, sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lm

    cfg, opt, init, batch = _sharded_setup(dev)

    def plain(remat=True, n_micro=1):
        def make():
            model = lm.LM(cfg, device=dev, dtype=torch.float32)
            model.load_state_dict(init)
            return model, opt.init(dict(model.named_parameters())), batch
        if n_micro > 1:
            return make, (lambda m, s, b: lm.train_step_accum(
                m, s, b, cfg, opt, n_micro=n_micro))
        return make, (lambda m, s, b: lm.train_step(m, s, b, cfg, opt,
                                                    remat=remat))

    out = {"arch": TRAIN_ARCH, "batch": int(TRAIN_ARGS[1]),
           "seq": int(TRAIN_ARGS[3]), "cases": {}}
    rec, params, mu = _sharded_case(*plain())
    ref = (rec["loss"], params, mu)
    out["cases"]["unsharded"] = rec
    log(f"[train_sharded] unsharded (remat full): {json.dumps(rec)}")
    for remat in ("dots", "none"):
        rec, params, mu = _sharded_case(*plain(remat))
        rec = _compare_case(f"remat {remat}", rec, params, mu, ref)
        out["cases"][f"remat_{remat}"] = rec
        log(f"[train_sharded] remat {remat}: {json.dumps(rec)}")
        del params, mu
    # The pipeline's M microbatches round as train_step_accum's do in
    # bfloat16: it is held to the unsharded step over the same microbatches
    # (whose own distance from the full batch's step is recorded).
    rec, params, mu = _sharded_case(*plain(n_micro=PP_MICRO))
    rec["loss_rel_diff"] = abs(rec["loss"] - ref[0]) / abs(ref[0])
    rec["mu_rel_diff"] = _rel_norm(mu, ref[2])
    ref_micro = (rec["loss"], params, mu)
    out["cases"][f"unsharded_micro{PP_MICRO}"] = rec
    log(f"[train_sharded] unsharded, {PP_MICRO} microbatches: "
        f"{json.dumps(rec)}")

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        mesh = mesh_lib.make_debug_mesh(1, 1, device_type="cuda")
        B = batch["tokens"].shape[0]
        for mode in SHARDED_MODES:
            def make(mode=mode):
                model = lm.LM(cfg, device=dev, dtype=torch.float32)
                model.load_state_dict(init)
                state = opt.init(dict(model.named_parameters()))
                sharding.distribute_model(model, mesh, mode)
                state = sharding.distribute_opt_state(state, model)
                return model, state, sharding.place_batch(batch, mesh,
                                                          mode=mode)
            pol = sharding.make_policy(mesh, batch=B, mode=mode)
            rec, params, mu = _sharded_case(
                make, lambda m, s, b, pol=pol: lm.train_step(
                    m, s, b, cfg, opt, pol=pol))
            rec = _compare_case(mode, rec, params, mu, ref)
            out["cases"][mode] = rec
            log(f"[train_sharded] {mode} on a (1, 1) NCCL mesh: "
                f"{json.dumps(rec)}")
            del params, mu

        def make_pp():
            model = lm.LM(cfg, device=dev, dtype=torch.float32)
            model.load_state_dict(init)
            pp = pipeline._from_full(model, cfg, mesh)
            return pp, pipeline.opt_init(pp, opt), batch
        pp_step = pipeline.make_pp_train_step(cfg, opt, mesh,
                                              n_micro=PP_MICRO)
        rec, params, mu = _sharded_case(make_pp, pp_step)
        rec = _compare_case(f"pipeline S = 1, M = {PP_MICRO}", rec, params,
                            mu, ref_micro)
        rec["mu_rel_diff_full_batch"] = _rel_norm(mu, ref[2])
        rec["pipeline_overhead"] = pp_step.pipeline_overhead
        out["cases"]["pipeline"] = rec
        log(f"[train_sharded] pipeline S = 1, M = {PP_MICRO}: "
            f"{json.dumps(rec)}")
        del params, mu
    finally:
        dist.destroy_process_group()
    del ref, ref_micro, init
    torch.cuda.empty_cache()
    out["two_ranks_one_card"] = _two_ranks_on_one_card()
    log(f"[train_sharded] ms a step / peak GB: " + json.dumps(
        {k: [round(v["ms_per_step"], 2), round(v["peak_gb"], 2)]
         for k, v in out["cases"].items()}))
    return out


def _flash_entry(dev, counts_by_path, flash_err):
    """The flash-decode kernel's line: ms, plain and library ms and the
    bound at each timed shape, cycling through enough input copies that
    each call finds its inputs outside the L2 cache, as a decode step
    does.  ``launches`` sums the counted runs of ``counts_by_path``
    (phase 8's engine run and phase 8b's, by path)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode, ref

    counts = {k: sum(c.get(k, 0) for c in counts_by_path.values())
              for k in ("flash_decode", "flash_decode_combine")}
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape = {}
    for i, (shape, dt_name) in enumerate(FLASH_TIMED):
        B, Hq, Hkv, D, T = shape
        dt = getattr(torch, dt_name)
        el = torch.finfo(dt).bits // 8
        nbytes = el * (B * Hq * D + 2 * B * T * Hkv * D) + 4 * B * Hq * D
        nops = 4 * B * Hq * T * D + 5 * B * Hq * T      # products, softmax
        copies = max(1, -(-120_000_000 // nbytes))
        sets = [_attn_inputs(shape, dt, dev, 1000 * i + c)
                for c in range(copies)]
        q, k, v = sets[0]
        lib_err = float((sdpa(q, k, v)[:, :, 0].float()
                         - flash_decode.flash_decode(q, k, v)).abs().max())
        check(lib_err <= 1e-2, f"scaled_dot_product_attention disagrees "
              f"with the kernel at {shape}: {lib_err}")
        iters = 50 if T > 4096 else 500
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S
        trace = _kernel_trace(
            lambda: flash_decode.flash_decode(q, k, v), SEARCH_TRACE_CALLS
            if T <= 4096 else 20)
        check(trace is not None, f"the profiler trace of flash decode at "
              f"{shape} shows no device time")
        by_shape[f"{shape} {dt_name}"] = {
            "device_us_per_call": sum(
                r[1] for r in trace["kernels"] if "flash_decode" in r[0]),
            "ms": time_ms_cycle(flash_decode.flash_decode, sets, iters),
            "plain_ms": time_ms_cycle(ref.flash_decode_ref, sets,
                                      max(20, iters // 5)),
            "library_ms": time_ms_cycle(sdpa, sets, iters),
            "splits": flash_decode.plan_splits(B, Hkv, T, sms)[0],
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_max_abs_diff": lib_err}
        del sets
        torch.cuda.empty_cache()
    main = by_shape[f"{FLASH_TIMED[0][0]} {FLASH_TIMED[0][1]}"]
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:66",
        "tpu_kernel": "repro/kernels/flash_decode.py::flash_decode_padded",
        "shape": list(FLASH_TIMED[0][0]), "dtype": FLASH_TIMED[0][1],
        "launches": counts["flash_decode"],
        "launches_per_run": counts["flash_decode"],
        "combine_launches": counts["flash_decode_combine"],
        "launches_by_path": {path: c.get("flash_decode", 0)
                             for path, c in counts_by_path.items()},
        "max_abs_err": max(flash_err["float32"], flash_err["bfloat16"]),
        "max_err": max(flash_err["float32"], flash_err["bfloat16"]),
        "max_abs_err_f32": flash_err["float32"],
        "max_abs_err_bf16": flash_err["bfloat16"],
        "ms": main["ms"], "kernel_ms": main["ms"],
        "device_us_per_call": main["device_us_per_call"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention"
                   "(enable_gqa=True)",
        "by_shape": by_shape}


def _bound(nbytes, nops):
    """(bound ms, "bytes" or "operations") at the card's peak rates."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / FP32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def eval_rows_ms(rows, dev, iters=300, warmup=20):
    """Mean wall ms per call of the batcher's ``eval_point_rows`` on the
    (M, 11) packed rows ``rows`` (numpy), with one stream and pinned
    buffers for all calls, as a dispatcher thread has; each call ends in
    its own wait."""
    from repro_torch.serving import batcher

    io = batcher._DeviceIO(dev)
    for _ in range(warmup):
        batcher.eval_point_rows(rows, dev, io)
    t0 = time.perf_counter()
    for _ in range(iters):
        batcher.eval_point_rows(rows, dev, io)
    return 1e3 * (time.perf_counter() - t0) / iters


def phase_timings(dev, counts, cost_err, lstm_err, multi_counts, multi_err,
                  path_counts):
    """Phase 9: each search kernel at the main path's shapes: CUDA-event ms
    per call, device µs per launch from a profiler trace, the bound, the
    plain version's and the library call's ms.  ``launches`` is phase 6's
    count (phase 7's for the per-row kernel); ``launches_by_path`` adds
    each counted run of phases 6b, 6c, 6d, 6e and 7b (``path_counts``: run ->
    counts).
    """
    import numpy as np
    import torch

    from repro_torch.costmodel import layers as layers_lib
    from repro_torch.costmodel import workloads
    from repro_torch.kernels import costmodel_eval, lstm_cell, ref

    arr = layers_lib.layers_to_array(workloads.get_workload("mobilenet_v2"))
    N = arr.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    search = search_kernel_times(dev)
    log(f"[timings] search path: {json.dumps(search)}")

    def cost_args(B, n):
        lt = _layers_table(arr[:n], dev)
        f = lambda hi: torch.randint(1, hi, (B, n), generator=gen,
                                     device=dev).to(torch.float32)
        return lt, f(161), f(17), torch.zeros((B, n), device=dev)

    by_shape = {}
    for B, n in ((1, 1), (20, N), (100, N), (144, N)):
        a = cost_args(B, n)
        by_shape[f"{B}x{n}"] = time_ms(lambda: costmodel_eval.cost_eval(*a),
                                       2000)
    a = cost_args(20, N)
    B = 20
    cost_main = search["cost_eval 20x53"]
    cost_entry = {
        "name": "cost_eval", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/costmodel_eval.cu",
        "replaces": "src/repro/kernels/costmodel_eval.py:60",
        "tpu_kernel": "repro/kernels/costmodel_eval.py::cost_eval_padded",
        "shape": [B, N], "launches": counts["cost_eval"],
        "launches_per_run": counts["cost_eval"],
        "max_abs_err": cost_err["abs"], "max_err": cost_err["abs"],
        "max_rel_err": cost_err["rel"],
        "ms": cost_main["ms"], "kernel_ms": cost_main["ms"],
        "device_us_per_launch": cost_main["kernel_device_us_per_launch"],
        "plain_ms": time_ms(lambda: ref.cost_eval_ref(*a), 300),
        "library_ms": None, "ms_by_shape": by_shape,
        "rollout_1x1": search["cost_eval 1x1"],
        "local_ga_table_cost_20x53": search["table_cost 20x53"]}
    cost_entry["bound_ms"], cost_entry["bound_by"] = _bound(
        4 * (3 * B * N + 4 * B * N + 8 * N), COST_OPS_PER_POINT * B * N)

    Bl, I, H = 1, 10, 128
    x, h, c, wx, wh, b = _lstm_inputs(Bl, I, H, dev, seed=7)
    w_ih, w_hh = wx.T.contiguous(), wh.T.contiguous()
    zero_b = torch.zeros_like(b)
    lib_out = torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zero_b)
    ker_out = lstm_cell.lstm_cell(x, h, c, wx, wh, b)[:2]
    check(all(float((p - q).abs().max()) <= 1e-5
              for p, q in zip(lib_out, ker_out)),
          "torch.lstm_cell disagrees with the LSTM kernel")
    weights = I * 4 * H + H * 4 * H + 4 * H
    lstm_main = search["lstm_cell 1x10x128"]
    lstm_entry = {
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:57",
        "tpu_kernel": "repro/kernels/lstm_cell.py::lstm_cell_padded",
        "shape": [Bl, I, H], "launches": counts["lstm_cell"],
        "launches_per_run": counts["lstm_cell"],
        "max_abs_err": lstm_err["fwd"], "max_err": lstm_err["fwd"],
        "max_gates_err": lstm_err["gates"], "max_grad_err": lstm_err["grad"],
        "ms": lstm_main["ms"], "kernel_ms": lstm_main["ms"],
        "device_us_per_launch": lstm_main["kernel_device_us_per_launch"],
        "autograd_forward": search["lstm_step autograd 1x10x128"],
        "plain_ms": time_ms(lambda: ref.lstm_cell_ref(x, h, c, wx, wh, b),
                            1000),
        "library_ms": time_ms(
            lambda: torch.lstm_cell(x, (h, c), w_ih, w_hh, b, zero_b), 1000),
        "library": "torch.lstm_cell"}
    lstm_entry["bound_ms"], lstm_entry["bound_by"] = _bound(
        4 * (Bl * I + 2 * Bl * H + weights + 2 * Bl * H),
        2 * Bl * (I + H) * 4 * H + LSTM_TAIL_OPS_PER_UNIT * Bl * H)

    # The backward at the same shape: the kernel's wrapper alone (ms, as
    # the other rows) on the single pass the search runs and, forced, on
    # the tiled kernel; and autograd's call of it over a kept graph.
    gates = lstm_cell.lstm_cell(x, h, c, wx, wh, b)[2:]
    dh, dc = (torch.randn((Bl, H), generator=gen, device=dev)
              for _ in range(2))
    bwd_main = search["lstm_cell_bwd wrapper 1x10x128"]
    tiled = lambda: lstm_cell.lstm_cell_bwd(x, h, c, wx, wh, gates, dh, dc,
                                            tiled=True)
    tiled_trace = _kernel_trace(tiled, SEARCH_TRACE_CALLS)
    check(tiled_trace is not None, "the profiler trace of the tiled LSTM "
          "backward shows no device time")
    lib_leaves = [t.clone().requires_grad_() for t in (x, h, c, w_ih, w_hh)]
    lib_outs = torch.lstm_cell(lib_leaves[0], (lib_leaves[1], lib_leaves[2]),
                               lib_leaves[3], lib_leaves[4],
                               b.clone().requires_grad_(), zero_b)
    bwd_entry = {
        "name": "lstm_cell_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_cell.cu",
        "replaces": None, "tpu_kernel": None,
        "shape": [Bl, I, H], "launches": counts["lstm_cell_bwd"],
        "launches_per_run": counts["lstm_cell_bwd"],
        "max_abs_err": lstm_err["bwd"], "max_err": lstm_err["bwd"],
        "ms": bwd_main["ms"], "kernel_ms": bwd_main["ms"],
        "device_us_per_launch": bwd_main["kernel_device_us_per_launch"],
        "path": "single pass",
        "tiled_ms": time_ms(tiled, 2000),
        "tiled_device_us_per_launch":
            _per_launch_us(tiled_trace, LSTM_BWD_KERNEL)[0],
        "autograd": search["lstm_cell_bwd 1x10x128"],
        "plain_ms": time_ms(lambda: ref.lstm_cell_bwd_ref(
            x, h, c, wx, wh, b, dh, dc), 300),
        "plain_saved_gates_ms": time_ms(lambda: ref.lstm_cell_bwd_saved_ref(
            x, h, c, wx, wh, gates, dh, dc), 300),
        "library_ms": time_ms(lambda: torch.autograd.grad(
            lib_outs, lib_leaves, (dh, dc), retain_graph=True), 300),
        "library": "torch.autograd.grad through torch.lstm_cell"}
    bwd_entry["bound_ms"], bwd_entry["bound_by"] = _bound(
        # x, h, c, the weights, the gates, dh', dc' read; dx, dh, dc and
        # the three weight gradients written.
        4 * (2 * Bl * I + 11 * Bl * H + 2 * weights - 4 * H),
        4 * Bl * (I + H) * 4 * H + Bl * 4 * H
        + LSTM_BWD_TAIL_OPS_PER_UNIT * Bl * H)

    # The per-row kernel at the service's flat shapes: an sa step (one
    # mobilenet_v2 genome), a GA generation of population 100 and a
    # random-search batch of 512, as the batcher calls it (its (M, 11)
    # upload read in place) and on contiguous (M, 8) and (M,) inputs, the
    # parent kernel's only form, both with (M, 4) rows out; and the whole
    # eval_point_rows (upload, launch, download, wait, on its own stream).
    rng = np.random.default_rng(3)
    multi_by_shape = {}
    for M in MULTI_SHAPES:
        a = _flat_points(arr, M, rng, dev)
        rows = torch.cat([a[0], *(v[:, None] for v in a[1:])], 1)
        cols = (rows[:, :8], rows[:, 8], rows[:, 9], rows[:, 10])
        forms = {"": lambda: costmodel_eval.cost_eval_multi(*cols),
                 "contiguous_": lambda: costmodel_eval.cost_eval_multi(*a)}
        row = {}
        for form, call in forms.items():
            trace = _kernel_trace(call, SEARCH_TRACE_CALLS)
            check(trace is not None, "the profiler trace of the per-row "
                  "cost kernel shows no device time")
            row[f"{form}ms"] = time_ms(call, 2000)
            row[f"{form}device_us_per_launch"] = _per_launch_us(
                trace, "cost_eval_multi_kernel")[0]
        multi_by_shape[f"1x{M}"] = {
            **row,
            "eval_point_rows_ms": eval_rows_ms(rows.cpu().numpy(), dev),
            "bound_ms": _bound(MULTI_BYTES_PER_POINT * M,
                               COST_OPS_PER_POINT * M)[0],
            "plain_ms": time_ms(lambda: ref.cost_eval_multi_ref(*a), 300)}
    M = 5300
    main = multi_by_shape[f"1x{M}"]
    multi_entry = {
        "name": "cost_eval_multi", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/costmodel_eval.cu",
        "replaces": "src/repro/kernels/costmodel_eval.py:102",
        "tpu_kernel":
            "repro/kernels/costmodel_eval.py::cost_eval_multi_padded",
        "shape": [1, M], "launches": multi_counts["cost_eval_multi"],
        "launches_per_run": multi_counts["cost_eval_multi"],
        "max_abs_err": multi_err["abs"], "max_err": multi_err["abs"],
        "max_rel_err": multi_err["rel"],
        "ms": main["ms"], "kernel_ms": main["ms"],
        "device_us_per_launch": main["device_us_per_launch"],
        "contiguous_ms": main["contiguous_ms"],
        "contiguous_device_us_per_launch": main[
            "contiguous_device_us_per_launch"],
        "plain_ms": main["plain_ms"], "library_ms": None,
        "threads_per_block": costmodel_eval.MULTI_THREADS,
        "by_shape": multi_by_shape}
    multi_entry["bound_ms"], multi_entry["bound_by"] = _bound(
        MULTI_BYTES_PER_POINT * M, COST_OPS_PER_POINT * M)
    for e in (cost_entry, lstm_entry, bwd_entry, multi_entry):
        e["launches_by_path"] = {
            "main": counts[e["name"]], "service": multi_counts[e["name"]],
            **{k: v[e["name"]] for k, v in path_counts.items()}}
        log(f"[timings] {e['name']}: {e['ms']:.4f} ms per call, "
            f"{e['device_us_per_launch']} µs of device time per launch, "
            f"bound {e['bound_ms']:.3g} ms ({e['bound_by']}), plain "
            f"{e['plain_ms']:.4f} ms, library {e['library_ms']} ms")
    log(f"[timings] lstm_cell_bwd tiled: {bwd_entry['tiled_ms']:.4f} ms per "
        f"call, {bwd_entry['tiled_device_us_per_launch']} µs of device time "
        "per launch")
    log(f"[timings] cost_eval_multi by shape: {json.dumps(multi_by_shape)}")
    return [cost_entry, lstm_entry, bwd_entry, multi_entry]


# Phases in the order they run (the keys of ``[phases] seconds``), and
# the earlier phases whose results each one reads.  ``--phases`` runs the
# named ones, those they read from, and ``build``.
PHASES = ("build", "cost", "cost_multi", "lstm", "flash", "main", "engines",
          "frontier", "fanout", "dist", "service", "http", "lm",
          "lm_families", "prefill", "serve_sharded", "train",
          "train_sharded", "timings", "flash_timings", "shard_timings")
PHASE_NEEDS = {
    "http": ("service",),
    "timings": ("cost", "cost_multi", "lstm", "main", "engines", "frontier",
                "fanout", "dist", "service", "http"),
    "flash_timings": ("flash", "lm", "lm_families"),
    "shard_timings": ("serve_sharded",),
}


def _selected(arg, quality_out):
    """The phases to run for ``--phases arg`` (all without it); says which
    ones run because a selected one reads their results."""
    if not arg:
        return set(PHASES)
    want = [p.strip() for p in arg.split(",") if p.strip()]
    unknown = sorted(set(want) - set(PHASES))
    if unknown:
        raise SmokeFailure(f"unknown phases {unknown}; the phases are "
                           f"{','.join(PHASES)}")
    run = set(want) | {"build"}
    if quality_out:
        run |= {"fanout", "dist"}
    todo = list(run)
    while todo:
        for dep in PHASE_NEEDS.get(todo.pop(), ()):
            if dep not in run:
                run.add(dep)
                todo.append(dep)
    for p in PHASES:
        if p in run and p not in want:
            why = [w for w in PHASES if w in run and p in PHASE_NEEDS.get(
                w, ())] or (["--quality-out"] if p in ("fanout", "dist")
                            and quality_out else ["every kernel phase"])
            log(f"[phases] {p} runs too: {', '.join(why)} reads its "
                "results")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="",
                    help="also write every measurement to this JSON file")
    ap.add_argument("--quality-out", default="",
                    help="also write phases 6d and 6e's search-quality "
                    "table (the card's arm) to this JSON file")
    ap.add_argument("--phases", default="",
                    help="run only these phases (comma-separated names of "
                    f"{', '.join(PHASES)}), those whose results they read, "
                    "and build")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    try:
        import torch

        card = phase_device()
        run = _selected(args.phases, args.quality_out)
        dev = torch.device("cuda", 0)
        from repro_torch.core import env as env_lib
        env_lib.resolve_device(dev)     # float32 products, TF32 off
        phase_s = {}

        def timed(name, fn, *a):
            if name not in run:
                return None
            t0 = time.perf_counter()
            out = fn(*a)
            phase_s[name] = time.perf_counter() - t0
            return out

        def pair(out):
            return (None, None) if out is None else out

        build_s = timed("build", phase_build)
        cost_err = timed("cost", phase_cost_kernel, dev)
        multi_err = timed("cost_multi", phase_multi_kernel, dev)
        lstm_err = timed("lstm", phase_lstm_kernel, dev)
        flash_err = timed("flash", phase_flash_kernel, dev)
        counts, timing = pair(timed("main", phase_main_path, EPOCHS,
                                    GA_GENERATIONS))
        engine_counts, engines = pair(timed("engines", phase_engines, dev))
        frontier_counts, frontier = pair(timed("frontier", phase_frontier,
                                               dev))
        fanout_counts, fanout = pair(timed("fanout", phase_fanout))
        dist_counts, dist_out = pair(timed("dist", phase_dist, dev))
        if args.quality_out:
            quality = fanout["quality"]
            Path(args.quality_out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.quality_out).write_text(json.dumps(
                {"card": card, "script": "chip_smoke.py phases 6d and 6e",
                 "reference": quality["reference"],
                 "configs": {**quality["configs"],
                             DIST_QUALITY: dist_out["quality"]}},
                indent=1) + "\n")
        service_counts, service, serial = (timed(
            "service", phase_service, dev) or (None, None, None))
        http_counts, http = pair(timed("http", phase_http, dev, serial,
                                       service))
        lm_counts, lm = pair(timed("lm", phase_lm, dev))
        family_counts, families = pair(timed("lm_families",
                                             phase_lm_families, dev))
        prefill = timed("prefill", phase_prefill, dev)
        serve_counts, serve_sharded = pair(timed(
            "serve_sharded", phase_serve_sharded, dev))
        training = timed("train", phase_train, dev)
        training_sharded = timed("train_sharded", phase_train_sharded, dev)
        kernels = timed("timings", phase_timings, dev, counts, cost_err,
                        lstm_err, service_counts, multi_err,
                        {f"{phase}_{k}": v
                         for phase, by_run in (("engines", engine_counts),
                                               ("frontier", frontier_counts),
                                               ("fanout", fanout_counts),
                                               ("dist", dist_counts),
                                               ("http", http_counts))
                         for k, v in (by_run or {}).items()}) or []
        flash = timed("flash_timings", _flash_entry, dev,
                      {"lm": lm_counts, "lm_families": family_counts},
                      flash_err)
        kernels += [flash] if flash else []
        kernels += timed("shard_timings", _shard_entries, dev, serve_counts,
                         (serve_sharded or {}).get("virtual_shards")) or []
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[phases] seconds {json.dumps(phase_s)}")
    log(json.dumps({"kernels": kernels}))
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "build_s": build_s, "main_path": timing,
             "engines_path": engines, "engines_launches": engine_counts,
             "frontier_path": frontier, "frontier_launches": frontier_counts,
             "fanout_path": fanout, "fanout_launches": fanout_counts,
             "dist_path": dist_out, "dist_launches": dist_counts,
             "service_path": service, "service_launches": service_counts,
             "http_path": http, "http_launches": http_counts,
             "lm_path": lm, "lm_launches": lm_counts,
             "lm_families_path": families,
             "lm_families_launches": family_counts,
             "prefill_path": prefill, "serve_sharded_path": serve_sharded,
             "serve_sharded_launches": serve_counts,
             "train_path": training,
             "train_sharded_path": training_sharded,
             "phase_s": phase_s, "phases": sorted(run),
             "kernels": kernels, **result}, indent=1))
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
