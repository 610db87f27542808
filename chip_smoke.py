#!/usr/bin/env python3
"""Drive the PyTorch port of FedCore on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  The
phases run in order and any failure exits non-zero:

1. set-up: the card's name and power limit, the torch and CUDA versions,
   TF32 off for matrix products and cuDNN convolutions, deterministic
   cuDNN, and the build of
   the eight CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one process per source, compiled in parallel); the pairwise
   kernel's k-loops, the k- and i-loops of the distance-free kernels'
   passes and the i-loops of kernels 2 and 3 (their column walks, kernel
   3's B segments) must hold no FFMA in their SASS (``cuobjdump``; their
   contract is a rounded product and then a rounded add a term);
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes: error, kernel / plain / library time, least time (the
   bound), at rtol 1e-5 and atol 1e-5·max|plain| (the two sum in the same
   order and should agree bit for bit; the tolerance is the one a
   reordered float32 sum would need); the 1e30 padded-candidate masks of
   the distance-free kernels must be equal exactly; flash attention at
   the JAX kernel tests' shapes, a ragged S, packed short sequences (S =
   16, 24, 32), the ``translm`` fleet's own shapes and the attention of
   one 4096-token sequence of yi-9b, llama4-scout (a GQA group of 5),
   zamba2's shared block (MHA at hd 64) and pixtral-12b (GQA 32/8 at hd
   160), and whisper-tiny's encoder (non-causal, 4 x 1,500 frames) and
   decoder (4 x 448), with
   ``scaled_dot_product_attention`` timed as the library yardstick: in
   fp32 (the SIMT kernel) it must
   agree with the plain version exactly, in bf16 (the tensor-core kernel,
   whose wgmma sums run in the hardware's order) it must be within 2e-2
   of it and its max and mean error against a float64 oracle at most 2x
   SDPA's (``bf16_attention_rule``), and its profile must show the wgmma
   kernel; RMSNorm at the JAX kernel test's shapes, the fleets' vmapped
   step (84 clients' scales, one group each), xlstm-125m's, yi-9b's
   (zamba2's d_inner), llama4-scout's (pixtral-12b's), zamba2's and
   whisper-tiny's widths, fp32 and
   bf16, which must agree with the plain version exactly, with
   ``torch.nn.functional.rms_norm`` timed as the yardstick; the cases
   with a shape key (the step shapes, the LM shapes) also print the
   card's busy time a call; the pairwise kernels (1 and 4) at phase 2's
   old shapes, the sync path's largest and median client (m = 341, 39)
   and every fleet group below the cutover that phases 6 and 8 log
   (D = 1568 and 32), each equal to its plain version bit for bit, with
   their busy time and ``torch.cdist``'s, both by CUDA events and by the
   card's busy time, in the same process; the distance-free kernels (5
   and 6) at phase 2's old shapes and at every selection group of the
   char-LM fleets at or above the cutover (F = 32), each equal to its
   plain version bit for bit, with their busy time and the floor of
   their distance pass; the D-input BUILD and Δ-sweep (kernels 2 and 3)
   bit for bit at their old shapes, every fleet group below the cutover,
   D and H off a 16-byte boundary, an H of several nonzeros a row of
   mixed sign, a dense H, and one slot holding 90 % of the rows, each
   with its busy time; and, once the lanes have ended, at the sync
   path's own (M, K), which phase 3 records;
3. the main path at full width: ``run_federated`` with ``FedCore`` on
   ``SmallCNN()`` (28x28, channels 16/32, F = 1568) over 200 pseudo-MNIST
   clients (Table 1 sizes: mean 69, std 106), 3 rounds of 10 clients,
   E = 5; the launch counts are set to 0 just before and read just after,
   and every kernel must have launched and every coreset been built on
   the card; the solves' (M, K) are logged as a histogram with their
   kernel-2 and kernel-3 launches;
4. the same run with ``use_kernel=False``: equal coresets (or tied ones,
   equal within 1e-5 in the float64 k-medoids objective) and final
   parameters within 1e-4;
5. ``LogisticRegression`` (60 -> 10) on Synthetic(0.5, 0.5) and
   ``CharLSTM`` (vocab 80, hidden 128, 2 layers) with client sizes cut to
   fit the time, 2 rounds each;
6. the fleet main path at full width: ``run_fleet(engine="batched")`` on a
   ``FleetWorkload`` of ``SmallCNN()`` over the same 200 clients, every
   client every round, 3 rounds, E = 5; the launch counts are set to 0
   just before and read just after, the fleet kernels (batched pairwise,
   distance-free BUILD and Δ-sweep, and the D-input BUILD and Δ-sweep)
   must each have launched, with cohort groups on both sides of the
   M = 256 cutover; then three more one-round runs: bare (the wall),
   with CUDA events around the gradient-feature passes, the selection
   solves and the distance-free solver's column and medoid-slab rebuilds
   (their stream time), and under ``torch.profiler`` (the device's busy
   time; the idle share is taken against the bare wall; the device time
   of the pairwise kernel and of kernels 2, 3, 5 and 6, which phases 8
   and 10 print too and which must not be 0);
7. the fleet A/Bs: the same 3 rounds with ``use_kernel=False`` pick the
   same medoids per (round, client) and end on bit-identical parameters;
   one round of ``engine="loop"`` picks the batched round's medoids and
   ends within the reference's ``PARAMS_ATOL`` (2e-4 for the CNN) of its
   parameters;
8. the ``translm`` fleet at the registry's widths (one pre-norm decoder
   block, d_model 32, two heads of 16, S = 16; attention through the
   flash-attention kernel, under ``vmap(grad)`` in the SGD steps):
   ``run_fleet(engine="batched")`` over 200 char-LM clients at the
   paper's Table-1 sizes, every client every round, 3 rounds, E = 5,
   selection groups on both sides of M = 256; the launch counts are set
   to 0 just before and read just after, and the attention kernel and the
   fleet's selection kernels must each have launched; round walls, wall
   by span, and one more round bare and one under ``torch.profiler``
   (idle share, device time by activity); then single vmapped SGD steps
   of the largest straggler group and of the group with the most
   clients, timed bare and under a host and device profile (ATen calls,
   kernel launches, device busy time and host time by op, per step);
9. the ``translm`` A/Bs: (a) the same 3 rounds with ``use_kernel=False``
   (selection on the plain versions) pick the same medoids per (round,
   client) and end every round on bit-identical parameters; (b) one round
   of ``engine="loop"`` picks the batched round's medoids and ends within
   the reference's ``PARAMS_ATOL`` for translm (1e-5); (c) at one batch
   of the largest group, attention through the kernel against the naive
   attention: logits within 1e-4, every parameter's gradient within
   1e-5·max|g|;
10. the ``xlstm`` fleet at the registry's widths (one mLSTM block,
    d_model 32, two heads of 16, S = 16; its RMSNorm through the RMSNorm
    kernel, under ``vmap(grad)`` in the SGD steps) over phase 8's 200
    clients and set-up: 3 batched rounds with the launch counts set to 0
    just before and read just after, the RMSNorm kernel and the selection
    kernels each launched; round walls, one more round bare and one
    under ``torch.profiler`` (idle share, device time by activity), and
    single vmapped SGD steps of the largest straggler group and of the
    group with the most clients;
11. the ``xlstm`` A/Bs: (a) ``use_kernel=False`` selection and (b)
    ``CharXLSTM(use_kernel=False)``, the plain RMSNorm on the card, each
    for the first ``XLSTM_AB_ROUNDS`` rounds: the same medoids per (round,
    client) and bit-identical parameters after every round; (c) on every
    ``XLSTM_LOOP_EVERY``-th client at ``XLSTM_LOOP_EPOCHS`` local epochs,
    one round of ``engine="loop"`` against one batched round: the same
    medoids, parameters within 1e-5; and at phase 10's E = 5, how far a
    1-ulp change of the initial parameters moves a batched round;
    (d) ``run_scenario("device_classes", "fleet", workload="xlstm")`` and
    ``run_scenario("uniform", "sync", workload="xlstm")`` at the
    registry's 24 clients for ``XLSTM_SCENARIO_ROUNDS`` rounds, each
    through the RMSNorm kernel;
12. the async main path at full width: ``run_federated_async`` with
    ``FedCore`` on ``SmallCNN()`` over phase 3's 200 clients and specs,
    E = 5, ``FedBuff(buffer_size=10)``, 3 applied updates (30 client
    updates) with 10 clients in flight; the launch counts are set to 0
    just before and read just after, kernels 1-3 must each have launched
    and every coreset been built on the card; its makespan, staleness
    histogram, wall by span and launches are printed; then the same run
    with ``use_kernel=False``: the event log equal byte for byte, the
    coresets equal (or tied by phase 4's rule) and the parameters within
    1e-4; then ``run_scenario("pareto", "async", aggregator=
    "delayed_grad", max_updates=20)`` on the same model and clients;
13. faults on the CNN fleet: phase 6's workload and clients under
    ``faults="hostile"`` with ``aggregator="trimmed_mean"``, 2 batched
    rounds, the fleet kernels each launched (groups on both sides of M =
    256) and every client's dropped and corrupted flags as the
    ``FaultTrace`` draws them; the same 2 rounds with
    ``use_kernel=False`` (the same medoids per (round, client),
    bit-identical parameters); one round of each of ``median``,
    ``krum``, ``multi_krum`` and ``norm_clip`` under
    ``byzantine_boost``; and ``run_scenario("uniform", "sync",
    faults="byzantine_noise", aggregator="median")`` for 2 rounds;
14. the async fleet engine on phase 6's workload, clients and specs:
    (a) ``run_async_fleet(engine="batched")`` with the FedBuff merge, 3
    flushes of 32 completions, 64 clients in flight, E = 5; the launch
    counts are set to 0 just before and read just after, and the fleet
    kernels (4, 2, 3, 5, 6) must each have launched, with a straggler
    group at M >= 256; each flush's groups as (M, k, C), the flush
    windows' walls, the makespan, the staleness and buffer-occupancy
    histograms, group against client dispatches, the wall by span
    (``cohort_build``, ``dispatch``, ``aggregate``, ``gather``,
    ``dispatch_wave``, ``buffer_fill``), and the same run under
    ``torch.profiler`` (the idle share against the main run's wall);
    (b) its ``use_kernel=False`` twin: the event log byte for byte, the
    medoids per (flush, client) and bit-identical parameters; (c)
    ``engine="loop"`` against a batched run, one flush each: the event
    logs and medoids equal, parameters within 2e-4; (d)
    ``run_scenario("pareto", "async_fleet", faults="hostile",
    aggregator="trimmed_mean", max_updates=2, clients_per_round=16)``:
    the dropped and corrupted counts a replay of the ``FaultTrace`` over
    its event log gives, and both trimmed-mean merges on the card;
15. checkpoint and resume, the JL projection and the ε audit: (a) phase
    6's fleet for 2 rounds with ``checkpoint_every=1`` (under
    ``build/chip_smoke/checkpoints/``), then ``resume=True`` to 3: the
    history equal to phase 6's, the params bit-identical, the fleet
    kernels (4, 2, 3, 5, 6) each launched in the resumed round; (b)
    phase 14's async fleet for 1 flush checkpointed, then resumed to 3:
    the event log and history equal to phase 14 (a)'s, the params
    bit-identical, the fleet kernels each launched after the resume; (c)
    phase 3's run for ``PROJECTED_ROUNDS`` round(s) at
    ``FedCoreConfig(projection_dim=256)``: kernels 1-3 each launched at
    F' = 256, and its ``use_kernel=False`` twin with equal coresets per
    (round, client) and bit-identical params; (d) one phase-3 client
    with m >= 160 at phase 3's final params: ``true_per_sample_grads``
    of the whole SmallCNN (P = 28,938), ε of a budget-24 coreset at F'
    = 1568, 256, 64 and 16 with each selection's wall, and ε at the
    full budget below 1e-5 of ‖Σg‖/m;
16. the dense LM path, serving: yi-9b at its published widths and full
    depth (48 layers, d_model 4096, 32 q heads, 4 kv heads, d_ff 11008,
    vocab 64000; 8.8 B fp32 parameters drawn on the card from a seed,
    after checking that 40 GiB of the card are free) through
    ``repro_torch.launch.serve.generate``: batch 4, prompt 16, 32 greedy
    tokens, the prompt prefilled token by token through the KV-cache
    decode; the launch counts are set to 0 just before and read just
    after (kernel 8 97 times a decode step, kernel 7 never); the wall,
    tokens/s and one decode step's idle share; its plain twin
    (``Model(use_kernel=False)``: the plain RMSNorm) gives the same
    tokens and bit-identical logits at every step; the first generated
    token is the argmax of ``Model.forward``'s last logits (or, where
    the top two are within 1e-5, a logit within 1e-5 of the max);
17. the dense LM path, prefill: the same model, one 4,096-token sequence
    through ``Model.forward`` without gradients, attention through
    kernel 7 (48 launches, 97 of kernel 8); the wall, the card's busy
    time and kernel 7's share of it; its plain twin (``impl="kernel"``
    with ``use_kernel=False``) bit-identical, and ``impl="chunked"``
    within 1e-4·max|logits|;
18. the dense LM path, training, at yi-9b's widths cut to 2 layers
    (0.87 B parameters): (a) ``train_centralized``, 20 Adam steps under
    the warmup-cosine schedule, gradients clipped to norm 1, batch 8 of
    128 tokens; the loss must fall, and the checkpoint must load back
    bit for bit; (b) ``train_fedcore_lm``, 2 rounds of 4 silos of 64
    sequences (8 steps of batch 8, seq 128), 30 % stragglers: the
    stragglers select on the card through kernels 1-3 at F = 4096, every
    round meets its deadline, and the plain twin (``use_kernel=False``
    for selection, attention and norms) picks equal coresets and gives
    equal losses and bit-identical parameters;
19. the sharded fleet on phase 6's workload, clients and specs: (c)
    ``FleetEngine.select_group_coresets`` on the largest straggler group
    (M = 512, k = 64), fused (one dispatch, kernels 5-6) and the
    pre-fusion chain (three dispatches, no kernel), the objectives within
    1e-6 relative or tied in the float64 objective, or, where the two
    reach distinct local optima, each within ``SELECT_QUALITY`` of the
    float64 BUILD + SWAP's objective, both walls; (d)
    ``workload_cost_model`` for the five fleet workloads: the CPU tests'
    FLOP counts; batched references of ``SHARDED_ROUNDS`` rounds and one
    async flush (phase 14's set-up); (a) one round of
    ``ShardedFleetEngine`` on a one-rank NCCL group: the batched round's
    medoids (or tied in the float64 objective), params within 1e-5,
    kernels 2-6 each launched; (b) ``SHARDED_RANKS`` ranks sharing the
    card over ``gloo`` (``chip_smoke.py --rank R N PID``, started by the
    lane): ``run_fleet(engine="sharded")`` for ``SHARDED_ROUNDS`` rounds
    and one flush of ``run_async_fleet(engine="sharded")``, each rank
    with the launch counts set to 0 just before and read just after
    (kernels 2-6 each launched): medoids per (round, client) equal to
    a batched round's from the same round-start params (round 0 the
    batched run's) or tied, params within the reference's CNN engine
    tolerance (2e-4: a rank's vmap of its block of a group's lanes moves
    a lane's params, as a lane-count A/B over every group shows) unless
    a tie parts them, the async event log equal byte for byte, both ranks'
    final params bit-identical, rank 0 alone recording; the round walls
    with the all-reduce's time a round, beside the batched rounds and
    phase 6's bare round;
20. the MoE LM path: llama4-scout-17b-a16e at its published widths
    (d_model 5120, 40 q / 8 kv heads of 128, d_ff 8192, 16 experts top-1
    with capacity dropping plus a shared expert, vocab 202048), its depth
    cut to 4 layers (the only cut: 10.88 B fp32 parameters drawn on the
    card, after checking that 60 GiB are free): (a) phase 17's prefill
    (4 launches of kernel 7 at a GQA group of 5, 9 of kernel 8), aux
    finite and in range, the tokens dropped and the largest expert load
    in each layer, each dropped token one past its expert's capacity;
    (b) phase 16's serving (kernel 8 9 times a decode step), the first
    token against a forward at a capacity of every token, since a decode
    step at batch 4 drops none;
21. the hybrid LM path: zamba2-1.2b at its published widths and depth
    (38 Mamba2 layers, d_model 2048, d_inner 4096, 64 SSM heads of 64,
    state 64, chunk 128, one shared attention block of 32 / 32 heads of
    64 after every 6 layers, tied vocab 32000; 1.11 B parameters, no
    cut): (a) phase 17's prefill (6 launches of kernel 7, 89 of kernel
    8), and ``ssd_chunked`` against ``ssd_sequential`` on layer 0's own
    inputs (1, 4096, 64, 64, N = 64) at rtol = atol = 1e-4; (b) phase
    16's serving (kernel 8 89 times a decode step, the Mamba states
    returned anew a step, the shared block's KV caches written in
    place);
22. the xLSTM LM path: xlstm-125m at its published widths and depth
    (blocks ``msmsmsmsmsms``, d_model 768, 4 heads of 192, tied vocab
    50304; 77.6 M parameters by ``ModelConfig.param_count``): (a) phase
    17's prefill (kernel 8 19 times: one norm an mLSTM block, two an
    sLSTM block, ln_f; no attention, so no kernel 7 and no chunked
    A/B), the sLSTM 4,096 dependent cell steps a block, its idle share
    logged, its plain twin at two blocks (``depth_cut``) and no untimed
    forward first: the host's calls dominate; (b) phase 16's serving (19
    launches of kernel 8 a decode step), the ATen calls a decode step;
23. the audio LM path: whisper-tiny at its published widths and depth
    (4 encoder + 4 decoder layers, d_model 384, 6 heads of 64, d_ff 1536,
    vocab 51865; no cut) at batch 4 over whisper's own 1,500 encoder
    frames and 448 text tokens, the frames drawn from a seed as the
    frontend stub's: (a) the forward (kernel 7 8 times: the encoder's
    non-causal layers at a ragged S, the decoder's causal ones;
    cross-attention takes the chunked path; kernel 8 22 times), its
    plain twin and the chunked A/B; (b) phase 16's serving over the zero
    encoder that ``init_decode_state`` makes (its 4 + 9 launches, then
    13 launches of kernel 8 a decode step); (c) 448 decode steps over
    the same frames, within rtol = atol = 3e-4 of the forward's logits
    (``tests/test_decode_parity.py``'s tolerance);
24. the VLM path: pixtral-12b at its published widths and depth (40
    layers, d_model 5120, 32 / 8 heads of 160, d_ff 14336, vocab 131072
    untied; 12.77 B fp32 parameters, 47.58 GiB, after checking that 60
    GiB are free; no cut): (a) a prefill of 4,096 positions, 1,024 patch
    embeddings drawn from a seed before 3,072 tokens (kernel 7 40 times
    at hd 160, kernel 8 81 times; logits over the tokens only; the plain
    twin against the kernels at a depth of ``VLM_TWIN_DEPTH`` = 8
    layers: the plain attention takes ~1.4 s a layer at this shape, and
    phase 2 holds kernel 7 there bit for bit); (b)
    phase 16's serving (81 launches of kernel 8 a decode step: the
    decode is the dense one and sees no patch);
25. the shape-only dry run (``repro_torch.launch.dryrun.dry_run``) at
    published widths on the production meshes of a fake world of 512
    ranks in the lane's own process, for ``DRYRUN_CASES``: yi-9b x
    prefill_32k x multi and whisper-tiny x decode_32k x single (the
    reference test's pair), llama4-maverick x train_4k x single in "tp"
    and "fsdp", zamba2-1.2b, granite-20b and mistral-large-123b (context
    parallel) x decode_32k x single; each record on a line of its own,
    ok with bytes a device and FLOPs above 0, and whether the bytes a
    device fit the card's 80 GB (a count of the trace, not a
    measurement);
26. after phase 21, in its lane: ``make_host_mesh()`` on the card (a (1,
    1) mesh over a world of one, NCCL), zamba2-1.2b's params placed by
    ``param_specs`` ("tp") as DTensors with ``distribute_tensor``, each
    local shard bit-identical to its param, and phase 21's 4,096-token
    prefill from the local shards through kernels 7 and 8 (as many
    launches as there), bit-identical to phase 21's logits.

Phases 1-2 run alone.  Phases 3-7, 12, 14 and 15 (the sync and async
runtimes and the CNN fleet), 8-9 (the ``translm`` fleet) and 10, 11 and
13 (the ``xlstm`` fleet, then the faulted CNN fleet on phase 6's fleet
and phase 3's clients made anew from their seeds, which keeps the three
lanes about as long) share no state, and each group is host-bound (the
card idles most of each round), so they run as three concurrent
processes on the one card, each a *lane* (``python3 chip_smoke.py
--lane NAME``, started by the script itself): a lane sets its own launch
counts to 0 around its main path, writes its launch counts and phase
seconds to ``build/chip_smoke/``, and its output is printed, lane by
lane, once every lane has ended.  Round walls, idle shares and step times of
phases 3-15 are therefore taken with the other two lanes running.
Phases 16-18 (the dense LM) then run as a fourth lane, ``lm``, alone:
its prefill keeps the card busy for seconds at a time, and the card's
time slicing between processes would stretch every wait of the
host-bound lanes (beside them on an H100 it made phase 5 2.3x slower).
Phase 19 runs next, as the lane ``sharded``, alone: its ranks are two
more processes on the card.  Phases 20-24 and 26 run last, as the lane
``lm_families``, apart from the host-bound lanes for the reason lane
``lm`` is; phase 25, which uses no card, runs beside it as the lane
``dryrun``.  A lane that
fails stops the others; lanes still running ``LANE_DEADLINE_S`` seconds
after the start are stopped and the script fails with what they printed
so far.

The last lines are the card (``nvidia-smi --query-gpu=name,power.limit``),
one JSON object of kernel numbers, and the result line
``{"ok": true, "device": {...}}``.  It prints no result and exits 1
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
LANE_DIR = ROOT / "build" / "chip_smoke"
# the lanes of phases 3-15, run concurrently, then the lanes of phases
# 16-18 and of phase 19, each alone, and those of phases 20-24 and 26 and
# of phase 25 together (see the module docstring)
LANES = ("sync_cnn", "translm", "xlstm")
LM_LANES = ("lm",)
SHARDED_LANES = ("sharded",)
# lane ``dryrun`` (phase 25) uses no card: it runs beside lm_families
FAMILY_LANES = ("lm_families", "dryrun")
# lanes still running this long after the start are stopped: the whole
# script must end within 1200 s
LANE_DEADLINE_S = 1140.0

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth; the bound of a kernel is the larger of its bytes over
# the bandwidth and its operations over the fp32 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12      # dense tensor-core rate, the bound of bf16 work
PEAK_BYTES_PER_S = 3.35e12
RTOL = 1e-5
PROFILER_TRIES = 3      # profiler sessions per timed call (see profiled_calls)
# the bf16 flash attention's check (``bf16_attention_rule``): within
# rtol = atol = BF16_ATTN_TOL of its plain version (the JAX kernel tests'
# bf16 tolerance), and its max and mean error against a float64 oracle
# at most BF16_ORACLE_FACTOR times SDPA's
BF16_ATTN_TOL = 2e-2
BF16_ORACLE_FACTOR = 2.0

KERNEL_META = {
    "pairwise_l2": ("src/repro_torch/kernels/csrc/pairwise_l2.cu",
                    "src/repro/kernels/pairwise_l2.py:75"),
    "build_cost": ("src/repro_torch/kernels/csrc/build_cost.cu",
                   "src/repro/kernels/kmedoids_pallas.py:92"),
    "delta_sweep": ("src/repro_torch/kernels/csrc/delta_sweep.cu",
                    "src/repro/kernels/kmedoids_pallas.py:156"),
    "pairwise_l2_batched": ("src/repro_torch/kernels/csrc/pairwise_l2.cu",
                            "src/repro/kernels/pairwise_l2.py:138"),
    "build_cost_from_feats": (
        "src/repro_torch/kernels/csrc/kmedoids_from_feats.cu",
        "src/repro/kernels/kmedoids_pallas.py:263"),
    "delta_sweep_from_feats": (
        "src/repro_torch/kernels/csrc/kmedoids_from_feats.cu",
        "src/repro/kernels/kmedoids_pallas.py:357"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:103"),
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:30"),
}
HEADLINE = {"pairwise_l2": (2048, 1568), "build_cost": (1, 2048),
            "delta_sweep": (2048, 700),
            "pairwise_l2_batched": (16, 128, 1568),
            "build_cost_from_feats": (1, 2048, 1568),
            "delta_sweep_from_feats": (1, 2048, 1568, 130),
            "flash_attention": "yi-9b fp32", "rmsnorm": "yi-9b fp32"}
# the kernels whose keyed phase-2 cases (the step shapes, yi-9b, the
# pairwise and distance-free kernels' main-path shapes) are all timed by
# the card's busy time, not their headline alone, and their library call
# too
REDESIGNED = ("flash_attention", "rmsnorm", "pairwise_l2",
              "pairwise_l2_batched", "build_cost_from_feats",
              "delta_sweep_from_feats", "build_cost", "delta_sweep")
# the main path each kernel belongs to: its launches in the kernels line
# are that path's (every path's counts are printed beside them)
PATH_OF = {"pairwise_l2": "sync", "build_cost": "sync",
           "delta_sweep": "sync", "pairwise_l2_batched": "fleet",
           "build_cost_from_feats": "fleet",
           "delta_sweep_from_feats": "fleet",
           "flash_attention": "lm_prefill", "rmsnorm": "lm_prefill"}
# the kernels each main path must launch
SYNC_KERNELS = ("pairwise_l2", "build_cost", "delta_sweep")
FLEET_KERNELS = ("pairwise_l2_batched", "build_cost_from_feats",
                 "delta_sweep_from_feats", "build_cost", "delta_sweep")
SELECTION_KERNELS = SYNC_KERNELS + FLEET_KERNELS[:3]
FEATS = 1568            # SmallCNN's feature width at 28x28, channels 16/32
# the reference's loop-vs-batched parameter tolerance
# (tests/test_workload_conformance.py PARAMS_ATOL)
PARAMS_ATOL_CNN = 2e-4
PARAMS_ATOL_TRANSLM = 1e-5
PARAMS_ATOL_XLSTM = 1e-5
# phase 11's depth, cut to keep the script inside its time: the rounds
# of the (a) and (b) A/Bs (phase 10 runs 3), the sub-fleet of (c) (every
# 5th client: a full loop round is about 6,700 serial SGD steps), and
# the rounds of (d)'s scenario runs
XLSTM_AB_ROUNDS = 1
XLSTM_LOOP_EVERY = 5
XLSTM_SCENARIO_ROUNDS = 2
# phases 16-18: the dense LM at yi-9b's published widths; phase 18 cuts
# its depth (the only cut) to 2 layers, so that weights, gradients and
# Adam's state (~13 GiB) fit beside the other lanes in the script's time
LM_ARCH = "yi-9b"
LM_MIN_FREE_GIB = 40.0
LM_SERVE = dict(batch=4, prompt_len=16, gen=32)
LM_PREFILL_S = 4096
LM_TRAIN_DEPTH = 2
LM_TRAIN = dict(steps=20, batch=8, seq=128, lr=3e-4)
LM_FEDCORE = dict(rounds=2, steps_per_epoch=8, silos=4, batch=8, seq=128,
                  lr=3e-4, straggler_pct=30.0, seed=0)
# the near-tie rule of phase 16's first token against the forward's argmax
LM_TIE = 1e-5
# phases 20-21: llama4-scout at its published widths, its depth cut to 4
# layers (the only cut: 10.88 B fp32 parameters, 40.5 GiB), and zamba2
# at its published widths and depth; the serving and prefill shapes are
# phases 16-17's
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_DEPTH = 4
MOE_MIN_FREE_GIB = 60.0
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_MIN_FREE_GIB = 12.0
# ssd_chunked against ssd_sequential, the reference's tolerance
# (tests/test_models.py: rtol = atol = 1e-4)
SSD_TOL = 1e-4
# phases 22-24, each uncut: xlstm-125m, whisper-tiny at its own sizes
# (arXiv:2212.04356: 30 s of audio are 1,500 encoder frames, a text
# context of 448 tokens) at batch 4, and pixtral-12b over
# ``Model._n_patches(4096)`` = 1,024 patches and 3,072 tokens
XLSTM_ARCH = "xlstm-125m"
XLSTM_MIN_FREE_GIB = 16.0
# its prefill is host-bound (~600 k ATen calls): the twin runs at two
# blocks (one of each kind), and no untimed forward precedes the timed one
XLSTM_TWIN_DEPTH = 2
AUDIO_ARCH = "whisper-tiny"
AUDIO_MIN_FREE_GIB = 8.0
AUDIO_SHAPE = dict(batch=4, frames=1500, text=448)
# decode against the forward, the reference's tolerance
# (tests/test_decode_parity.py: rtol = atol = 3e-4)
DECODE_TOL = 3e-4
VLM_ARCH = "pixtral-12b"
VLM_MIN_FREE_GIB = 60.0
# the depth of pixtral's prefill twin, against the kernels at that depth:
# the plain attention takes ~1.4 s a layer at (1, 32, 8, 4096, 160), and
# phase 2 holds kernel 7 at that shape bit for bit
VLM_TWIN_DEPTH = 8
# phase 25: the shape-only dry run (``repro_torch.launch.dryrun``) at
# published widths on the fake world's production meshes, as (arch,
# shape, mesh, sharding, context_parallel): the reference test's pair,
# llama4-maverick's train step in both modes, the Mamba state rules,
# MQA's unsharded kv heads and a context-parallel cache
DRYRUN_CASES = (("yi-9b", "prefill_32k", "multi", "tp", False),
                ("whisper-tiny", "decode_32k", "single", "tp", False),
                ("llama4-maverick-400b-a17b", "train_4k", "single", "tp",
                 False),
                ("llama4-maverick-400b-a17b", "train_4k", "single", "fsdp",
                 False),
                ("zamba2-1.2b", "decode_32k", "single", "tp", False),
                ("granite-20b", "decode_32k", "single", "tp", False),
                ("mistral-large-123b", "decode_32k", "single", "tp", True))
CARD_BYTES = 80e9       # an H100's device memory, for phase 25's count
# (c)'s local epochs: at phase 10's E = 5 the exponential gating makes a
# round's result move far beyond 1e-5 under a 1-ulp change of its inputs
# (the loop and batched engines differ in the matrix products' rounding,
# about 1e-7), so their A/B at 1e-5 runs E = 2, where it does not
XLSTM_LOOP_EPOCHS = 2


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(fn, target_ms: float = 60.0) -> float:
    """Mean device time of one call, by CUDA events over many calls after
    a warm-up (inputs stay warm in L2, as the main path leaves them); a
    call above 500 ms is timed once."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    if one > 500.0:     # a call of seconds (plain attention at yi-9b)
        return one
    reps = int(max(5, min(200, target_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float, peak_flops: float = PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairwise_floor_ms(key) -> float:
    """The least time of a pairwise kernel's terms under its contract: a
    rounded multiply and a rounded add take two fp32 issue slots a term,
    where the peak counts an FFMA (two operations) in one, so the floor
    is 4 operations a term over the fp32 peak.  ``key`` is (m, d) or
    (C, M, D); self mode sums each client's triangle."""
    c, m, d = key if len(key) == 3 else (1, *key)
    return 4.0 * c * m * (m + 1) / 2 * d / PEAK_FP32_FLOPS * 1e3


def compare(got, want):
    """(max abs err, max rel err, within tolerance).  The 1e30 masks of
    padded candidates must be equal exactly and are left out of the
    scale."""
    import torch
    g, w = got.double(), want.double()
    big = w.abs() >= 1e29
    if not torch.equal(g[big], w[big]):
        return float("inf"), float("inf"), False
    g, w = g[~big], w[~big]
    err = (g - w).abs()
    scale = float(w.abs().max()) if w.numel() else 0.0
    atol = RTOL * scale
    ok = bool((err <= atol + RTOL * w.abs()).all())
    max_abs = float(err.max()) if err.numel() else 0.0
    return max_abs, max_abs / max(scale, 1e-30), ok


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_cases(dev, attn_shapes, pairwise_groups, from_feats_groups,
                 kmedoids_groups=()):
    """(kernel, label, shape key, run(use_kernel) -> tensors, bytes, ops,
    library call or None, peak FLOP/s of the operations' type, rule) at
    the main paths' shapes; ``attn_shapes`` names the ``translm`` fleet's
    own attention shapes, ``pairwise_groups`` the fleets' (C, M, D)
    selection groups below the distance-free cutover,
    ``from_feats_groups`` the char-LM fleets' (C, M, F, k) groups at or
    above it, ``kmedoids_groups`` the fleets' (C, M, k) groups below it
    (kernels 2 and 3)."""
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    # (341, 1568) and (39, 1568): the sync path's largest and median
    # sampled client (mnist_like_dataset(200, seed=0) sizes 10-341)
    # (64, 4096): phase 18's FedCore-for-LM silo of 64 sequences at
    # yi-9b's width
    for m, d in ((37, 60), (39, 1568), (341, 1568), (1000, 1568),
                 (2048, 1568), (2048, 128), (64, 4096)):
        x = torch.randn(m, d, generator=g, device=dev)

        def run(uk, x=x):
            return (ops.pairwise_l2(x, squared=True, zero_diag=True,
                                    use_kernel=uk),)

        def lib(x=x):
            return torch.cdist(x, x).square()

        # the function's operations: the norms, and a multiply-add a term
        # and the epilogue (add, multiply, subtract, max) for each output
        # of the triangle, the other half being its mirror image
        tri = m * (m + 1) / 2
        cases.append(("pairwise_l2", f"m={m} d={d}", (m, d), run,
                      4.0 * (m * d + m * m),
                      2.0 * m * d + tri * (2.0 * d + 4.0),
                      lib, PEAK_FP32_FLOPS, "exact"))
    for c in (1, 4):
        for m in (37, 1000, 2048):
            D = torch.rand(c, m, m, generator=g, device=dev)
            dn = torch.rand(c, m, generator=g, device=dev)
            vf = (torch.rand(c, m, generator=g, device=dev) < 0.9).float()
            cases.append(build_cost_case(f"C={c} M={m}", (c, m), D, dn,
                                         vf))
    # the fleet's selection group below the cutover: C=25, M=128, k=64
    D = torch.rand(25, 128, 128, generator=g, device=dev)
    dn = torch.rand(25, 128, generator=g, device=dev)
    vf = (torch.rand(25, 128, generator=g, device=dev) < 0.9).float()
    cases.append(build_cost_case("C=25 M=128 (fleet)", (25, 128), D, dn, vf))
    for c, m, ks in ((1, 37, (1, 7)), (1, 1000, (1, 7, 130, 700)),
                     (1, 2048, (1, 7, 130, 700)), (25, 128, (64,))):
        D = torch.rand(c, m, m, generator=g, device=dev)
        d1 = torch.rand(c, m, generator=g, device=dev)
        d2 = d1 + torch.rand(c, m, generator=g, device=dev)
        vf = (torch.rand(c, m, generator=g, device=dev) < 0.9).float()
        for k in ks:
            idx = torch.randint(0, k, (c, m), generator=g, device=dev)
            oh = torch.nn.functional.one_hot(idx, k).float()
            label = (f"M={m} K={k}" if c == 1
                     else f"C={c} M={m} K={k} (fleet)")
            cases.append(delta_sweep_case(
                label, (m, k) if c == 1 else (c, m, k), D, d1, d2, vf, oh))
    cases += kmedoids_cases(dev, kmedoids_groups)

    # the fleet's kernels: per-client pairwise stacks below the cutover,
    # the distance-free BUILD and Δ-sweep at and above it, at SmallCNN's
    # feature width; kernel 4 also at every group below the cutover of
    # phases 6 and 8 (C=25, M=128 and C=8, M=16 at D=1568; the char-LM
    # fleets' at D=32)
    fleet_shapes = sorted(set(pairwise_groups) - {(16, 128, FEATS),
                                                  (3, 37, 60)})
    for c, m, d in [(16, 128, FEATS), (3, 37, 60)] + fleet_shapes:
        x = torch.randn(c, m, d, generator=g, device=dev)

        def run(uk, x=x):
            return (ops.pairwise_l2_batched(x, zero_diag=True,
                                            use_kernel=uk),)

        def lib(x=x):
            return torch.cdist(x, x)

        # as kernel 1's, over each client's triangle; the epilogue adds
        # a square root
        tri = c * m * (m + 1) / 2
        cases.append(("pairwise_l2_batched", f"C={c} M={m} D={d}"
                      + (" (fleet)" if (c, m, d) in pairwise_groups
                         else ""), (c, m, d),
                      run, 4.0 * (c * m * d + c * m * m),
                      2.0 * c * m * d + tri * (2.0 * d + 5.0), lib,
                      PEAK_FP32_FLOPS, "exact"))
    # C=22, M=256, K=64 is the CNN fleet's main distance-free group
    # (phase 6); the char-LM fleets' groups at F = 32 (phase 8) follow
    shapes = [(4, 512, FEATS, False, (1, 7, 130)),
              (4, 512, FEATS, True, (7,)),
              (1, 2048, FEATS, False, (1, 7, 130)),
              (22, 256, FEATS, False, (64,))]
    lm = {}
    for c, m, f, k in from_feats_groups:
        lm.setdefault((c, m, f), []).append(k)
    shapes += [(c, m, f, False, tuple(ks)) for (c, m, f), ks in lm.items()]
    for c, m, f, padded, ks in shapes:
        x = torch.randn(c, m, f, generator=g, device=dev)
        vf = torch.ones(c, m, device=dev)
        if padded:      # ragged clients: a zeroed tail of padded rows
            n = torch.randint(m // 2, m + 1, (c,), generator=g, device=dev)
            vf = (torch.arange(m, device=dev)[None] < n[:, None]).float()
            x = x * vf[..., None]
        dn = 60.0 * torch.rand(c, m, generator=g, device=dev)
        fleet = (" (fleet)" if (c, m) == (22, 256) or (c, m, f) in lm
                 else "")
        tag = (f"C={c} M={m} F={f}" + (" padded" if padded else "")
               + fleet)
        key = (c, m, f) + (("padded",) if padded else ())

        def run(uk, x=x, dn=dn, vf=vf):
            return (ops.kmedoids_build_cost_from_feats(x, dn, vf,
                                                       use_kernel=uk),)

        # the norms; over each client's triangle the 2F dot and the 5
        # epilogue operations (the other half is its mirror); per (i, j)
        # the 3 BUILD operations
        tri = c * m * (m + 1) / 2
        cases.append(("build_cost_from_feats", tag, key, run,
                      4.0 * (c * m * f + 3 * c * m),
                      2.0 * c * m * f + tri * (2.0 * f + 5.0)
                      + 3.0 * c * m * m, None, PEAK_FP32_FLOPS, "exact"))
        d1 = 60.0 * torch.rand(c, m, generator=g, device=dev)
        d2 = d1 + 10.0 * torch.rand(c, m, generator=g, device=dev)
        for k in ks:
            idx = torch.randint(0, k, (c, m), generator=g, device=dev)
            oh = torch.nn.functional.one_hot(idx, k).float()

            def run(uk, x=x, d1=d1, d2=d2, vf=vf, oh=oh):
                return ops.kmedoids_delta_sweep_from_feats(
                    x, d1, d2, vf, oh, use_kernel=uk)

            # the norms and the triangle as above; per (i, j) 4 A and 4
            # contrib operations; one multiply-add per one-hot nonzero
            # and j
            nnz = float((oh != 0).sum())
            cases.append(("delta_sweep_from_feats", f"{tag} K={k}",
                          key[:3] + (k,) + key[3:], run,
                          4.0 * (c * m * f + 4 * c * m + 2 * c * m * k),
                          2.0 * c * m * f + tri * (2.0 * f + 5.0)
                          + 8.0 * c * m * m + 2.0 * nnz * m, None,
                          PEAK_FP32_FLOPS, "exact"))
    cases += attention_cases(dev, g, attn_shapes)
    cases += rmsnorm_cases(dev, g)
    return cases


def misaligned(x):
    """A contiguous copy of ``x`` whose storage starts 4 bytes past a
    16-byte boundary (a kernel's 4-byte copy path)."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def build_cost_case(label, key, D, dn, vf):
    """A phase-2 case of kernel 2 on D (C, M, M), d_near and vf (C, M):
    D once, 3 operations an element."""
    from repro_torch.kernels import ops

    c, m = D.shape[:2]

    def run(uk, D=D, dn=dn, vf=vf):
        return (ops.kmedoids_build_cost(D, dn, vf, use_kernel=uk),)

    return ("build_cost", label, key, run, 4.0 * (c * m * m + 3 * c * m),
            3.0 * c * m * m, None, PEAK_FP32_FLOPS, "exact")


def delta_sweep_case(label, key, D, d1, d2, vf, H):
    """A phase-2 case of kernel 3: D, H and B once; the data's work, 8
    elementwise operations and one A add per (i, j), and a multiply and
    an add per nonzero of H and j."""
    import torch

    from repro_torch.kernels import ops

    c, m, k = H.shape

    def run(uk, D=D, d1=d1, d2=d2, vf=vf, H=H):
        return ops.kmedoids_delta_sweep(D, d1, d2, vf, H, use_kernel=uk)

    nnz = float((H != 0).sum())
    return ("delta_sweep", label, key, run,
            4.0 * c * (m * m + 4 * m + 2 * m * k),
            9.0 * c * m * m + 2.0 * nnz * m, None, PEAK_FP32_FLOPS, "exact")


def sweep_inputs(g, c, m, dev):
    """Random D (C, M, M) and d1 <= d2, vf (C, M) for kernels 2 and 3."""
    import torch

    D = torch.rand(c, m, m, generator=g, device=dev)
    d1 = torch.rand(c, m, generator=g, device=dev)
    d2 = d1 + torch.rand(c, m, generator=g, device=dev)
    vf = (torch.rand(c, m, generator=g, device=dev) < 0.9).float()
    return D, d1, d2, vf


def onehot(g, c, m, k, dev):
    import torch

    idx = torch.randint(0, k, (c, m), generator=g, device=dev)
    return torch.nn.functional.one_hot(idx, k).float()


def kmedoids_cases(dev, groups):
    """Kernels 2 and 3 beyond their old cases: D off a 16-byte boundary,
    an H that is not one-hot (two to four nonzeros a row of mixed sign
    and not 1, a zero row; a dense H), one slot holding 90 % of the rows,
    and each fleet group below the cutover, (C, M, k) of ``groups``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(19)
    cases = []
    D, d1, _, vf = sweep_inputs(g, 1, 2048, dev)
    cases.append(build_cost_case("C=1 M=2048 misaligned",
                                 (1, 2048, "misaligned"), misaligned(D),
                                 d1, vf))
    D, d1, d2, vf = sweep_inputs(g, 1, 2048, dev)
    cases.append(delta_sweep_case(
        "M=2048 K=130 misaligned", (2048, 130, "misaligned"), misaligned(D),
        d1, d2, vf, misaligned(onehot(g, 1, 2048, 130, dev))))
    idx = torch.where(torch.rand(1, 2048, generator=g, device=dev) < 0.9,
                      0, 1 + torch.randint(0, 6, (1, 2048), generator=g,
                                           device=dev))
    cases.append(delta_sweep_case(
        "M=2048 K=7 uneven", (2048, 7, "uneven"), D, d1, d2, vf,
        torch.nn.functional.one_hot(idx, 7).float()))
    D, d1, d2, vf = sweep_inputs(g, 1, 256, dev)
    H = torch.randn(1, 256, 16, generator=g, device=dev)
    H = H * (torch.rand(1, 256, 16, generator=g, device=dev) < 0.2)
    H[0, 7] = 0.0
    cases.append(delta_sweep_case("M=256 K=16 multi", (256, 16, "multi"),
                                  D, d1, d2, vf, H))
    D, d1, d2, vf = sweep_inputs(g, 1, 64, dev)
    cases.append(delta_sweep_case(
        "M=64 K=64 dense", (64, 64, "dense"), D, d1, d2, vf,
        torch.randn(1, 64, 64, generator=g, device=dev)))
    shown = {(25, 128), (25, 128, 64)}
    for c, m, k in sorted(set(groups)):
        D, d1, d2, vf = sweep_inputs(g, c, m, dev)
        if (c, m) not in shown:
            shown.add((c, m))
            cases.append(build_cost_case(f"C={c} M={m} (fleet)", (c, m), D,
                                         d1, vf))
        if (c, m, k) not in shown:
            shown.add((c, m, k))
            cases.append(delta_sweep_case(
                f"C={c} M={m} K={k} (fleet)", (c, m, k), D, d1, d2, vf,
                onehot(g, c, m, k, dev)))
    return cases


def sync_cases(dev, shapes, path="sync"):
    """Kernels 2 and 3 at a D-input path's own shapes: ``shapes`` holds
    the (M, k) of its solves (phase 3's, or phase 18's with ``path``
    "lm"); kernel 2 at each M, kernel 3 at each (M, k) with a one-hot
    H."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for m in sorted({m for m, _ in shapes}):
        D, d1, _, vf = sweep_inputs(g, 1, m, dev)
        cases.append(build_cost_case(f"C=1 M={m} ({path})", (1, m, path),
                                     D, d1, vf))
    for m, k in sorted(set(shapes)):
        D, d1, d2, vf = sweep_inputs(g, 1, m, dev)
        cases.append(delta_sweep_case(f"M={m} K={k} ({path})",
                                      (m, k, path), D, d1, d2, vf,
                                      onehot(g, 1, m, k, dev)))
    return cases


def attention_cases(dev, g, attn_shapes):
    """Flash attention (kernel 7) cases in ``kernel_cases``'s form, at
    (B, Hq, Hk, S, hd, window, dtype, what, shape key[, causal]): causal
    unless the tenth entry says otherwise.  fp32 runs the SIMT kernel,
    which must equal its plain version exactly (packed blocks for S <=
    32); bf16 the tensor-core kernel, held by ``bf16_attention_rule``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(2, 4, 2, 128, 64, None, f32, "JAX test", None),
              (1, 4, 4, 256, 32, None, f32, "JAX test", None),
              (2, 8, 1, 128, 64, None, f32, "JAX test", None),
              (1, 2, 2, 64, 128, None, f32, "JAX test", None),
              (1, 4, 2, 128, 64, 16, f32, "JAX test", None),
              (1, 4, 2, 128, 64, 48, f32, "JAX test", None),
              (1, 4, 2, 128, 64, 128, f32, "JAX test", None),
              (1, 2, 2, 128, 64, None, bf16, "JAX test", None),
              (1, 4, 2, 128, 64, 16, bf16, "JAX test", None),
              (1, 4, 2, 128, 64, 128, bf16, "JAX test", None),
              (2, 4, 2, 40, 64, None, f32, "ragged S", None),
              (2, 4, 2, 40, 64, None, bf16, "ragged S", None)]
    shapes += [(96, 2, 2, s, 16, None, f32, f"packed, S={s}", None)
               for s in (16, 24, 32)]
    shapes += [(b, 2, 2, 16, 16, None, f32, label, key)
               for b, label, key in attn_shapes]
    shapes += [(attn_shapes[0][0], 2, 2, 16, 16, None, bf16,
                attn_shapes[0][1], attn_shapes[0][2] + " bf16")]
    shapes += [(1, 32, 4, 4096, 128, None, dt, "yi-9b train_4k",
                "yi-9b " + ("bf16" if dt == bf16 else "fp32"))
               for dt in (f32, bf16)]
    # phases 20-21's prefills: llama4-scout's GQA group of 5 and
    # zamba2's shared block (MHA at hd 64)
    shapes += [(1, 40, 8, 4096, 128, None, f32, "llama4-scout prefill",
                "scout fp32"),
               (1, 32, 32, 4096, 64, None, f32, "zamba2 shared block",
                "zamba2 fp32")]
    # phase 18's training shape: batch 8 of 128 tokens
    shapes += [(8, 32, 4, 128, 128, None, f32, "yi-9b, phase 18",
                "yi-9b S=128")]
    # phases 23-24: whisper-tiny's encoder (non-causal, 1,500 frames: no
    # multiple of the 64-key tile) and decoder at batch 4, pixtral-12b's
    # layers (GQA 32/8 at hd 160) over 1,024 patches and 3,072 tokens
    shapes += [(4, 6, 6, 1500, 64, None, f32, "whisper-tiny encoder",
                "whisper enc fp32", False),
               (4, 6, 6, 448, 64, None, f32, "whisper-tiny decoder",
                "whisper dec fp32"),
               (1, 32, 8, 4096, 160, None, f32, "pixtral-12b prefill",
                "pixtral fp32")]
    cases = []
    for b, hq, hk, s, hd, window, dt, what, key, *causal in shapes:
        causal = causal[0] if causal else True
        q = torch.randn(b, hq, s, hd, generator=g, device=dev).to(dt)
        k = torch.randn(b, hk, s, hd, generator=g, device=dev).to(dt)
        v = torch.randn(b, hk, s, hd, generator=g, device=dev).to(dt)

        def run(uk, q=q, k=k, v=v, window=window, causal=causal):
            return (ops.flash_attention(q, k, v, causal=causal,
                                        window=window, use_kernel=uk),)

        mask = ref.attention_mask(s, causal, window, dev)

        def lib(q=q, k=k, v=v, mask=mask, windowed=window is not None,
                gqa=hq != hk, causal=causal):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask if windowed else None,
                is_causal=causal and not windowed, enable_gqa=gqa)

        # the work: 4·hd operations per visible (q, k) pair and head (the
        # score and the weighted sum of V); each of q, k, v read once and
        # the output written once
        pairs = float(mask.sum())
        label = (f"B={b} Hq={hq} Hk={hk} S={s} hd={hd}"
                 + (f" window={window}" if window else "")
                 + ("" if causal else " non-causal")
                 + (" bf16" if dt == bf16 else "") + f" ({what})")
        rule = (bf16_attention_rule(q, k, v, window, lib) if dt == bf16
                else "exact")
        cases.append(("flash_attention", label, key, run,
                      float(q.element_size() * (2 * q.numel() + k.numel()
                                                + v.numel())),
                      4.0 * hd * pairs * b * hq, lib,
                      PEAK_BF16_FLOPS if dt == bf16 else PEAK_FP32_FLOPS,
                      rule))
    return cases


def bf16_attention_rule(q, k, v, window, lib):
    """The check of the bf16 tensor-core path, whose sums inside a wgmma
    run in the hardware's order, which no plain version can repeat: (i)
    the kernel within rtol = atol = 2e-2 of its plain version (which
    rounds P to bf16 alike), and (ii) the kernel's max and mean absolute
    error against the float64 oracle (``ref.flash_attention_f64`` on the
    same bf16 inputs) each at most 2x those of SDPA (``lib``).  Returns a
    ``check(got, want) -> (max abs, max rel, ok, note)``."""
    def check(got, want):
        from repro_torch.kernels import ref

        g, w = got[0].double(), want[0].double()
        err = (g - w).abs()
        within = bool((err <= BF16_ATTN_TOL + BF16_ATTN_TOL * w.abs()).all())
        oracle = ref.flash_attention_f64(q, k, v, window=window)
        errs = {who: (float(e.max()), float(e.mean())) for who, e in (
            ("kernel", (g - oracle).abs()), ("plain", (w - oracle).abs()),
            ("sdpa", (lib().double() - oracle).abs()))}
        (km, ka), (sm, sa) = errs["kernel"], errs["sdpa"]
        ok = within and km <= BF16_ORACLE_FACTOR * sm and \
            ka <= BF16_ORACLE_FACTOR * sa
        note = (f"(i) within {BF16_ATTN_TOL:g} of plain: {within}; (ii) "
                f"against the float64 oracle, max / mean abs error: "
                + ", ".join(f"{who} {mx:.3e} / {mean:.3e}"
                            for who, (mx, mean) in errs.items())
                + f" (kernel's at most {BF16_ORACLE_FACTOR:g}x SDPA's)")
        scale = float(w.abs().max()) if w.numel() else 0.0
        mx = float(err.max()) if err.numel() else 0.0
        return mx, mx / max(scale, 1e-30), ok, note
    return check


def rmsnorm_cases(dev, g):
    """RMSNorm (kernel 8) cases in ``kernel_cases``'s form at (x shape,
    groups G, dtype, what, shape key): with G = 1 the public op on x with
    one scale row, with G > 1 the op's Function on x (G, m, d) and one
    scale row per group, as the vmap rule gives it the fleet's clients.
    No single PyTorch call takes a scale per group, so there
    ``F.rms_norm`` runs with one scale row: the same work but for G − 1
    scale rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(shape, 1, dt, "JAX test", None)
              for shape in ((4, 37, 96), (256, 512), (1, 1, 8))
              for dt in (f32, bf16)]
    shapes += [((84, 8 * 16, 32), 84, f32, "fleet step, 84 clients' scales",
                "step"),
               ((4096, 768), 1, f32, "xlstm-125m width", "xlstm")]
    shapes += [((4096, 4096), 1, dt, "yi-9b width, zamba2 d_inner",
                "yi-9b " + ("bf16" if dt == bf16 else "fp32"))
               for dt in (f32, bf16)]
    # phases 20-21's prefill rows: llama4-scout's d_model (pixtral-12b's
    # too, phase 24), zamba2's; phase 23's whisper-tiny encoder, 4 x
    # 1,500 frames of 384
    shapes += [((4096, 5120), 1, f32, "llama4-scout, pixtral-12b width",
                "scout"),
               ((4096, 2048), 1, f32, "zamba2 width", "zamba2"),
               ((6000, 384), 1, f32, "whisper-tiny encoder", "whisper")]
    # phase 16's decode step (B, 1, d) and phase 18's training rows
    shapes += [((4, 1, 4096), 1, f32, "yi-9b decode, batch 4",
                "yi-9b decode"),
               ((8, 128, 4096), 1, f32, "yi-9b, phase 18", "yi-9b train")]
    cases = []
    for shape, gr, dt, what, key in shapes:
        d = shape[-1]
        x = torch.randn(shape, generator=g, device=dev).to(dt)
        scale = torch.randn(gr, d, generator=g, device=dev)
        w = scale[0].to(dt)

        def run(uk, x=x, scale=scale, gr=gr):
            if gr == 1:
                return (ops.rmsnorm(x, scale[0], use_kernel=uk),)
            return (ops._RMSNorm.apply(x, scale, 1e-5, uk),)

        def lib(x=x, w=w, d=d):
            return F.rms_norm(x, (d,), weight=w, eps=1e-5)

        # x read once, each group's scale read once, y written once; per
        # element a square, an add and two multiplies
        label = (f"x={tuple(shape)} G={gr}" + (" bf16" if dt == bf16 else "")
                 + f" ({what})")
        cases.append(("rmsnorm", label, key, run,
                      float(2 * x.element_size() * x.numel()
                            + 4 * scale.numel()),
                      4.0 * x.numel(), lib, PEAK_FP32_FLOPS, "exact"))
    return cases


def phase_kernels(dev, cases, results=None):
    """Each case's kernel against its plain version (``compare``; an
    "exact" case must agree to the bit, a callable rule is the case's own
    check), with its times; the case whose key ``HEADLINE`` names (its
    kernel's headline) and every keyed case of a ``REDESIGNED`` kernel
    are also timed by the card's busy time, and for a ``REDESIGNED``
    kernel so is its library call.  Adds to ``results`` (kernel ->
    errors, headline numbers, timed cases) and returns it."""
    import torch

    # the first profiler session of a process may see no device activity
    device_busy_share(lambda: torch.ones(1, device=dev).sum())
    results = {} if results is None else results
    for name, label, key, run, nbytes, nops, lib, peak, rule in cases:
        got, want = run(True), run(False)
        note = None
        if callable(rule):
            max_abs, max_rel, ok, note = rule(got, want)
        else:
            errs = [compare(a, b) for a, b in zip(got, want)]
            max_abs = max(e[0] for e in errs)
            max_rel = max(e[1] for e in errs)
            ok = all(e[2] for e in errs)
            if rule == "exact":     # the same arithmetic in the same order
                ok = ok and max_abs == 0.0
        ms = time_ms(lambda: run(True))
        plain_ms = time_ms(lambda: run(False))
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops, peak)
        lib_s = ("none (no single PyTorch call computes it)"
                 if lib_ms is None else f"{lib_ms:.4f} ms")
        log(f"  {name:22s} {label:24s} max_abs {max_abs:.3e} max_rel "
            f"{max_rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {lib_s} "
            f"bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'MISMATCH'}")
        if note:
            log(f"    {note}")
        if name.startswith("pairwise") or "from_feats" in name:
            # kernels 5 and 6: the floor of their distance pass alone
            log(f"    {key}: floor under the kernel's contract "
                f"{pairwise_floor_ms(key[:3]):.4f}"
                " ms" + (" (the triangle's terms)" if "from_feats" in name
                         else ""))
        check(ok, f"{name} {label}: kernel disagrees with its plain version "
              f"(max abs {max_abs:.3e})")
        r = results.setdefault(name, {"max_abs_err": 0.0,
                                      "max_abs_err_exact": 0.0, "cases": {}})
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        if rule == "exact":
            r["max_abs_err_exact"] = max(r["max_abs_err_exact"], max_abs)
        if key != HEADLINE[name] and (key is None or name not in REDESIGNED):
            continue
        # back-to-back calls of a fast kernel time the wrapper's host
        # path; the profiler gives the card's own busy time a call
        _, busy, by_name = profiled_calls(
            lambda: [run(True) for _ in range(20)])
        dev_ms = None if busy is None else busy / 20 * 1e3
        # both pairwise entry points run pairwise_l2_kernel<...>, kernels
        # 5 and 6 their from_feats_* passes
        kname = ("pairwise_l2_kernel" if name.startswith("pairwise") else
                 "from_feats" if "from_feats" in name else name)
        ran = sorted({n.replace("(anonymous namespace)::", "")
                      .split("(")[0][-60:] for n in by_name if kname in n})
        log(f"    {key}: device busy "
            + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
            + f" a call (torch.profiler, 20 calls); kernels {ran}")
        if name == "flash_attention" and key.endswith("bf16"):
            check(any("wgmma" in n for n in ran),
                  f"{label}: the bf16 call ran no wgmma kernel ({ran})")
        lib_dev_ms = None
        if lib is not None and name in REDESIGNED:
            _, lbusy, _ = profiled_calls(
                lambda: [lib() for _ in range(20)])
            lib_dev_ms = None if lbusy is None else lbusy / 20 * 1e3
            log(f"    {key}: library device busy "
                + ("not measured" if lib_dev_ms is None
                   else f"{lib_dev_ms:.4f} ms")
                + " a call (torch.profiler, 20 calls)")
        case = dict(shape=label, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                    library_device_ms=lib_dev_ms, max_abs_err=max_abs)
        r["cases"][str(key)] = case
        if key == HEADLINE[name]:
            r.update({f: v for f, v in case.items() if f != "max_abs_err"})
    return results


# ---------------------------------------------------------------------------
# phases 3-5: the FL runtime
# ---------------------------------------------------------------------------

def recording_fedcore():
    from repro_torch.fed import FedCore

    class RecordingFedCore(FedCore):
        """FedCore that keeps each selection's features and indices."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.selected = []

        def select_coreset(self, feats, budget):
            cs = super().select_coreset(feats, budget)
            self.selected.append((feats.detach().cpu().numpy(), int(budget),
                                  cs.indices.cpu().numpy()))
            return cs

    return RecordingFedCore


def run_fl(model, clients, cfg, use_kernel=None, projection_dim=None):
    """One run_federated on the card with recording on; returns (output,
    strategy, span records, launch counts, wall seconds)."""
    import numpy as np
    import torch

    from repro_torch.core.coreset import FedCoreConfig
    from repro_torch.fed import LocalTrainer, make_client_specs, run_federated
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    specs = make_client_specs([len(d["y"]) for d in clients],
                              np.random.default_rng(0))
    strategy = recording_fedcore()(
        LocalTrainer(model, cfg.lr, cfg.batch_size),
        FedCoreConfig(use_kernel=use_kernel, projection_dim=projection_dim))
    init = model.init(torch.Generator().manual_seed(cfg.seed))
    sink = InMemorySink()
    rec = Recorder([sink])
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(rec):
        out = run_federated(model, clients, specs, strategy, cfg,
                            init_params=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    return out, strategy, sink.records, launches, wall


def report_rounds(out, records):
    spans = [r for r in records if r["kind"] == "span"]
    by_sid = {s["sid"]: s for s in spans}

    def round_of(s):
        while s is not None and s["name"] != "round":
            s = by_sid.get(s["parent"])
        return None if s is None else s["attrs"]["round"]

    sel = {}
    for s in spans:
        if s["name"] == "selection":
            r = round_of(s)
            sel[r] = sel.get(r, 0.0) + s["dur"]
    rounds = {s["attrs"]["round"]: s["dur"] for s in spans
              if s["name"] == "round"}
    for h in out["history"]:
        share = sel.get(h.round, 0.0) / max(rounds.get(h.round, 0.0), 1e-12)
        log(f"  round {h.round}: sim_round_time {h.sim_round_time:.4f} "
            f"n_coreset {h.n_coreset} n_violations {h.n_violations} "
            f"wall {rounds.get(h.round, 0.0):.3f} s selection "
            f"{sel.get(h.round, 0.0):.3f} s ({100 * share:.1f}% of the "
            f"round) train_loss {h.train_loss:.4f}")
    phase_s = {}
    for s in spans:
        if s["name"] in ("cohort_select", "grad_features", "selection",
                         "local_sgd", "coreset_epochs", "aggregate"):
            phase_s[s["name"]] = phase_s.get(s["name"], 0.0) + s["dur"]
    total = max(sum(rounds.values()), 1e-12)
    log("  wall by phase: " + ", ".join(
        f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
        for k, v in sorted(phase_s.items(), key=lambda kv: -kv[1])))
    devices = {s["attrs"].get("device") for s in spans
               if s["name"] == "selection"}
    total_sel = sum(sel.values())
    total_round = sum(rounds.values())
    return devices, total_sel, total_round


def check_params(out):
    import torch
    for k, v in out["params"].items():
        check(v.device.type == "cuda", f"param {k} left the card")
        check(bool(torch.isfinite(v).all()), f"param {k} is not finite")


@contextlib.contextmanager
def solver_shapes():
    """While open, record each D-input k-medoids solve (the sync path's,
    through ``repro_torch.core.kmedoids._kmedoids_batched``) by (M, k),
    with the kernel-2 and kernel-3 launches it made: yields {(M, k):
    [solves, kernel-2 launches, kernel-3 launches]}."""
    from repro_torch.core import kmedoids
    from repro_torch.kernels import ops

    inner = kmedoids._kmedoids_batched
    hist = {}

    def recorded(D, valid, k, *args):
        n2, n3 = ops.LAUNCHES["build_cost"], ops.LAUNCHES["delta_sweep"]
        out = inner(D, valid, k, *args)
        h = hist.setdefault((int(D.shape[1]), int(k)), [0, 0, 0])
        h[0] += 1
        h[1] += ops.LAUNCHES["build_cost"] - n2
        h[2] += ops.LAUNCHES["delta_sweep"] - n3
        return out

    kmedoids._kmedoids_batched = recorded
    try:
        yield hist
    finally:
        kmedoids._kmedoids_batched = inner


def log_solver_shapes(hist):
    """The histogram of kernels 2 and 3's launches by (M, k), and the
    median M of their launches."""
    ms = sorted(m for (m, _), (_, n2, n3) in hist.items()
                for _ in range(n2 + n3))
    log("  kernels 2 and 3 by (M, K), solves / kernel-2 / kernel-3 "
        "launches: " + ", ".join(f"({m}, {k}) {a}/{b}/{c}" for (m, k),
                                  (a, b, c) in sorted(hist.items()))
        + (f"; median M of their launches {ms[len(ms) // 2]}" if ms else ""))


def phase_main_path():
    from repro_torch.data import mnist_like_dataset
    from repro_torch.fed import FLConfig
    from repro_torch.models import SmallCNN

    t0 = time.perf_counter()
    clients = mnist_like_dataset(n_clients=200, seed=0)
    sizes = [len(d["y"]) for d in clients]
    log(f"  data: 200 pseudo-MNIST clients, {sum(sizes)} samples, sizes "
        f"{min(sizes)}..{max(sizes)}, made in "
        f"{time.perf_counter() - t0:.1f} s")
    model = SmallCNN()
    cfg = FLConfig(rounds=3, clients_per_round=10, epochs=5, batch_size=8,
                   lr=0.03, straggler_pct=30.0)
    with solver_shapes() as hist:
        out, strat, records, launches, wall = run_fl(model, clients, cfg)
    devices, sel_s, round_s = report_rounds(out, records)
    log(f"  wall {wall:.2f} s; selection {sel_s:.3f} s of {round_s:.3f} s "
        f"in rounds ({100 * sel_s / max(round_s, 1e-12):.1f}%); "
        f"{len(strat.selected)} coresets, budgets "
        f"{[b for _, b, _ in strat.selected]} of m "
        f"{[len(f) for f, _, _ in strat.selected]}")
    log(f"  launches on the main path: {launches}")
    log_solver_shapes(hist)
    check(len(strat.selected) > 0, "no coreset was built on the main path")
    check(all(launches[k] > 0 for k in SYNC_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    check(all(str(d).startswith("cuda") for d in devices),
          f"a coreset was built off the card: {devices}")
    check_params(out)
    return clients, cfg, out, strat, launches, sorted(hist)


def phase_plain_ab(clients, cfg, kout, kstrat):
    from repro_torch.models import SmallCNN

    pout, pstrat, _, launches, wall = run_fl(SmallCNN(), clients, cfg,
                                             use_kernel=False)
    log(f"  plain run: wall {wall:.2f} s, launches {launches}")
    check(all(n == 0 for n in launches.values()),
          f"use_kernel=False launched a kernel: {launches}")
    check_plain_selections(kout, kstrat, pout, pstrat)


def check_plain_selections(kout, kstrat, pout, pstrat):
    """A kernel run's selections against a plain run's: every kernel-run
    selection equal to the plain solver's on the same features, or tied
    with it in the float64 objective (1e-5 relative); the runs' coresets
    equal up to a tie, and their final parameters within 1e-4 when no
    selection parted them."""
    import numpy as np
    import torch

    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.kmedoids import medoid_objective_f64

    check(len(pstrat.selected) == len(kstrat.selected),
          "the plain run built another number of coresets")
    first_diff = None
    for s, ((f, b, ki), (_, _, pi)) in enumerate(zip(kstrat.selected,
                                                     pstrat.selected)):
        if not np.array_equal(ki, pi):
            first_diff = s
            break
    n_tied = 0
    dev = next(iter(kout["params"].values())).device
    # every kernel-run selection against the plain solver on the same
    # features: equal, or a tie in the float64 objective
    for s, (f, b, ki) in enumerate(kstrat.selected):
        pi = build_coreset(torch.as_tensor(f, device=dev), b,
                           use_kernel=False).indices.cpu().numpy()
        if np.array_equal(ki, pi):
            continue
        fk, fp = medoid_objective_f64(f, ki), medoid_objective_f64(f, pi)
        rel = abs(fk - fp) / max(abs(fp), 1e-30)
        log(f"  selection {s}: kernel and plain coresets differ, f64 "
            f"objectives {fk:.10g} vs {fp:.10g} (rel {rel:.2e})")
        check(rel <= 1e-5, f"selection {s}: coresets differ beyond a tie")
        n_tied += 1
    log(f"  {len(kstrat.selected)} selections on identical features: "
        f"{len(kstrat.selected) - n_tied} equal, {n_tied} tied")
    max_diff = max(float((kout["params"][k] - pout["params"][k]).abs().max())
                   for k in kout["params"])
    if first_diff is None:
        log(f"  every coreset of the two runs is equal; final params max "
            f"abs diff {max_diff:.3e}")
        check(max_diff <= 1e-4, f"final params differ by {max_diff:.3e}")
    else:
        f, b, ki = kstrat.selected[first_diff]
        pi = pstrat.selected[first_diff][2]
        fk, fp = medoid_objective_f64(f, ki), medoid_objective_f64(f, pi)
        rel = abs(fk - fp) / max(abs(fp), 1e-30)
        log(f"  the runs part at selection {first_diff} on a tie (f64 rel "
            f"{rel:.2e}); final params max abs diff {max_diff:.3e}")
        check(rel <= 1e-5, f"the runs part at selection {first_diff} on "
              "coresets that are not tied")
    check_params(pout)


def phase_other_models():
    from repro_torch.data import shakespeare_like_dataset, synthetic_dataset
    from repro_torch.fed import FLConfig
    from repro_torch.models import CharLSTM, LogisticRegression

    runs = (
        ("LogisticRegression 60->10, Synthetic(0.5, 0.5), 30 clients",
         LogisticRegression(), lambda: synthetic_dataset(0.5, 0.5),
         FLConfig(rounds=2, clients_per_round=5, epochs=5, batch_size=8,
                  lr=0.03, straggler_pct=30.0)),
        ("CharLSTM vocab 80 hidden 128 x2, 24 clients of mean 48 windows",
         CharLSTM(), lambda: shakespeare_like_dataset(
             n_clients=24, mean_samples=48.0, std_samples=32.0, seed=0),
         FLConfig(rounds=2, clients_per_round=5, epochs=3, batch_size=8,
                  lr=0.03, straggler_pct=30.0)),
    )
    for label, model, make, cfg in runs:
        clients = make()
        out, strat, records, launches, wall = run_fl(model, clients, cfg)
        devices, sel_s, round_s = report_rounds(out, records)
        log(f"  {label}: wall {wall:.2f} s, {len(strat.selected)} coresets "
            f"(budgets {[b for _, b, _ in strat.selected]} of m "
            f"{[len(f) for f, _, _ in strat.selected]}), launches "
            f"{launches}")
        check(len(strat.selected) > 0, f"{label}: no coreset was built")
        check(all(launches[k] > 0 for k in SYNC_KERNELS),
              f"{label}: a kernel never launched: {launches}")
        check(all(str(d).startswith("cuda") for d in devices),
              f"{label}: a coreset was built off the card")
        check_params(out)


# ---------------------------------------------------------------------------
# phases 6-7: the fleet runtime
# ---------------------------------------------------------------------------

def cnn_fleet_workload():
    """The paper's SmallCNN (28x28, channels 16/32) as a FleetWorkload,
    built from the port's own class, on pseudo-MNIST clients at the
    paper's Table-1 sizes."""
    from repro_torch.data import mnist_like_dataset
    from repro_torch.fed.fleet import ArraySpec, FleetWorkload
    from repro_torch.models import SmallCNN

    def make_clients(n_clients=200, seed=0):
        return mnist_like_dataset(n_clients=n_clients, seed=seed)

    return FleetWorkload(
        name="cnn", model=SmallCNN(image_size=28, channels=(16, 32)),
        schema={"x": ArraySpec((28, 28), "float32"),
                "y": ArraySpec((), "int32")},
        make_clients=make_clients,
        description="SmallCNN at the paper's widths on pseudo-MNIST")


def run_fleet_recorded(wl, clients, specs, cfg, rounds, engine, faults=None,
                       stats=None, **kwargs):
    """One ``run_fleet`` on the card with recording on, keeping each
    round's medoids {cid: indices} and aggregated parameters (and its
    ``FleetRoundStats`` in ``stats``, a list, when given); ``kwargs`` go
    to ``run_fleet``.  Returns (output, [(medoids, params)] per round,
    span records, launch counts, wall seconds)."""
    import numpy as np
    import torch

    import repro_torch.fed.fleet.batched as fleet_batched
    from repro_torch.fed.fleet import run_fleet
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    kept = []
    inner = fleet_batched.run_fleet_round

    def recording_round(*args, **kwargs):
        params, round_stats = inner(*args, **kwargs)
        kept.append(({int(c): np.asarray(m) for c, m in
                      round_stats.medoids.items()},
                     {k: v.clone() for k, v in params.items()}))
        if stats is not None:
            stats.append(round_stats)
        return params, round_stats

    sink = InMemorySink()
    fleet_batched.run_fleet_round = recording_round
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(Recorder([sink])):
            out = run_fleet(wl, clients, specs, cfg, rounds,
                            straggler_pct=30.0, engine=engine,
                            faults=faults, **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        fleet_batched.run_fleet_round = inner
    return out, kept, sink.records, launches, wall


def report_fleet_rounds(records):
    """Round walls and the wall by phase, over all rounds and over the
    rounds after the first (which also pays for first-call set-up)."""
    spans = [r for r in records if r["kind"] == "span"]
    by_sid = {s["sid"]: s for s in spans}
    rounds = [s for s in spans if s["name"] == "round"]

    def round_of(s):
        while s is not None and s["name"] != "round":
            s = by_sid.get(s["parent"])
        return None if s is None else s["attrs"]["round"]

    log("  round wall s: " + ", ".join(f"{r['dur']:.3f}" for r in rounds))
    for label, keep in (("all rounds", lambda r: True),
                        ("rounds after the first", lambda r: r > 0)):
        top, inner = {}, {"grad_features": 0.0, "selection": 0.0}
        for s in spans:
            if s["depth"] == 1 and keep(round_of(s)):
                top[s["name"]] = top.get(s["name"], 0.0) + s["dur"]
            if s["name"] in inner and keep(round_of(s)):
                inner[s["name"]] += s["dur"]
        total = max(sum(r["dur"] for r in rounds
                        if keep(r["attrs"]["round"])), 1e-12)
        log(f"  wall by phase, {label}: " + ", ".join(
            f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
            for k, v in sorted(top.items(), key=lambda kv: -kv[1]))
            + "; of which " + ", ".join(
                f"{k} {v:.3f} s ({100 * v / total:.1f}%)"
                for k, v in inner.items()))
    return inner["selection"], total


def device_busy_share(fn):
    """Run ``fn`` under ``torch.profiler`` (device activity only); returns
    (wall s, device busy s, {device activity name: s}) with busy the union
    of the card's kernel and copy intervals, or None for busy when the
    profiler saw no device activity.  The profiler's raw events are read
    directly: building its Python event tree for a round of a few hundred
    thousand launches takes minutes."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA]
    by_name = {}
    for name, a, b in dev_events:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    spans = sorted((a, b) for _, a, b in dev_events)
    if not spans:
        return wall, None, by_name
    busy, cur0, cur1 = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur1:
            busy += cur1 - cur0
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
    busy += cur1 - cur0
    return wall, busy * 1e-9, by_name


def profiled_calls(fn):
    """``device_busy_share(fn)``, run again while the profiler saw no
    device activity at all (a profiling session on the card can miss
    every event: calls whose kernels ran then read "not measured", and
    a check on which kernels ran would fail on nothing); up to
    ``PROFILER_TRIES`` sessions, the last one's result."""
    for _ in range(PROFILER_TRIES):
        res = device_busy_share(fn)
        if res[1] is not None:
            break
    return res


def fleet_setup(wl, clients):
    """Specs, config and round-0 cohort groups of a 200-client fleet
    (capabilities from seed 0, E = 5, B = 8, lr 0.03, 30 % stragglers);
    the selection groups must fall on both sides of the M = 256
    cutover."""
    import numpy as np

    from repro_torch.fed.fleet import (FleetConfig, client_sizes,
                                       make_cohort_groups, nominal_budgets)
    from repro_torch.fed.simulator import (make_client_specs,
                                           straggler_deadline)

    wl.validate_clients(clients)
    specs = make_client_specs(client_sizes(clients),
                              np.random.default_rng(0))
    cfg = FleetConfig(epochs=5, batch_size=8, lr=0.03)
    deadline = straggler_deadline(specs, cfg.epochs, 30.0)
    groups = make_cohort_groups(
        clients, list(range(len(clients))),
        nominal_budgets(specs, deadline, cfg.epochs), cfg)
    sel_m = [g.valid.shape[1] for g in groups if g.k > 0]
    check(any(m < cfg.materialize_below for m in sel_m)
          and any(m >= cfg.materialize_below for m in sel_m),
          f"no selection groups on both sides of M = "
          f"{cfg.materialize_below}: {sel_m}")
    return specs, cfg, groups


def selection_groups(wl, clients, cfg, groups, dev):
    """((C, M, F, k) of each selection group below the distance-free
    cutover: kernel 4's calls, then kernels 2 and 3's; (C, M, F, k) of
    each at or above it: kernels 5 and 6's), F the workload's
    gradient-feature width."""
    import torch

    params = wl.init(torch.Generator().manual_seed(0), dev)
    batch = {k: torch.as_tensor(v[:2], device=dev)
             for k, v in clients[0].items()}
    f = int(wl.grad_features(params, batch).shape[-1])
    sel = [(g.n_clients, g.valid.shape[1], f, g.k) for g in groups
           if g.k > 0]
    return ([s for s in sel if s[1] < cfg.materialize_below],
            [s for s in sel if s[1] >= cfg.materialize_below])


def phase2_groups(dev):
    """Phase 2's shapes from the fleets' round-0 groups: (the ``translm``
    fleet's attention shapes, the (C, M, F) groups below the cutover of
    the CNN and char-LM fleets, the char-LM fleets' (C, M, F, k) groups at
    or above it, the (C, M, k) groups below it), ``kernel_cases``'s
    arguments."""
    twl, tclients, _, tcfg, tgroups = translm_fleet()
    cwl = cnn_fleet_workload()
    cclients = cwl.make_clients()
    _, ccfg, cgroups = fleet_setup(cwl, cclients)
    cnn_below, _ = selection_groups(cwl, cclients, ccfg, cgroups, dev)
    lm_below, lm_above = selection_groups(twl, tclients, tcfg, tgroups, dev)
    below = cnn_below + lm_below
    return (translm_attention_shapes(tcfg, tgroups),
            [(c, m, f) for c, m, f, _ in below], lm_above,
            [(c, m, k) for c, m, _, k in below])


def log_groups(groups):
    log("  groups (M, k, C): " + ", ".join(
        f"({g.valid.shape[1]}, {g.k}, {g.n_clients})" for g in groups))


def bare_and_profiled(one_round, top=8):
    """One more round bare (the wall) and one under ``torch.profiler``
    (the card's busy time; the profiler inflates the wall, so the idle
    share is taken against the bare one).  Returns (bare wall s, busy s
    or None, {device activity: s})."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    bare_wall = time.perf_counter() - t0
    log(f"  one more round, bare: wall {bare_wall:.3f} s")
    pwall, busy, by_name = device_busy_share(one_round)
    if busy is None:
        log("  device busy share: not measured (the profiler saw no "
            "device activity)")
        return bare_wall, None, by_name
    log(f"  device busy (one more round under torch.profiler, wall "
        f"{pwall:.3f} s): busy {busy:.3f} s; idle "
        f"{100 * (1 - busy / bare_wall):.1f}% of the bare round's wall "
        f"{bare_wall:.3f} s ({100 * (1 - busy / pwall):.1f}% of the "
        f"profiled round's)")
    log(f"  device time by activity, top {top}: " + "; ".join(
        f"{name[:60]} {t:.3f} s ({100 * t / busy:.1f}%)"
        for name, t in sorted(by_name.items(),
                              key=lambda kv: -kv[1])[:top]))
    return bare_wall, busy, by_name


def log_kernel_time(by_name, busy, what, match):
    """Log the device time of a profiled round's kernels whose name holds
    ``match``; the round must have run one (unless the profiler saw no
    device activity at all)."""
    if busy is None:
        return
    t = sum(v for name, v in by_name.items() if match in name)
    check(t > 0, f"the profiled round ran no {what} kernel")
    log(f"  {what} kernel: {1e3 * t:.4f} ms of device time "
        f"({100 * t / busy:.2f}% of the busy time)")


def fleet_main_run(wl, clients, specs, cfg, required):
    """The fleet main path: 3 batched rounds with the launch counts set to
    0 just before and read just after; every kernel of ``required`` must
    have launched.  Returns (kept rounds, launch counts, output)."""
    out, kept, records, launches, wall = run_fleet_recorded(
        wl, clients, specs, cfg, 3, "batched")
    sel_s, round_s = report_fleet_rounds(records)
    for h in out["history"]:
        log(f"  round {h.round}: sim_round_time {h.sim_round_time:.4f} "
            f"n_coreset {h.n_coreset} n_violations {h.n_violations} "
            f"train_loss {h.train_loss:.4f}")
    log(f"  wall {wall:.2f} s; selection {100 * sel_s / round_s:.1f}% of "
        f"the wall of the rounds after the first; "
        f"{sum(len(m) for m, _ in kept)} coresets")
    log(f"  launches on the fleet path: {launches}")
    check(all(launches[k] > 0 for k in required),
          f"a kernel never launched on the fleet path: {launches}")
    check(launches["pairwise_l2"] == 0,
          f"the fleet path launched the single-matrix pairwise kernel: "
          f"{launches}")
    check(all(h.n_coreset > 0 for h in out["history"]),
          "a fleet round built no coreset")
    check_params(out)
    return kept, launches, out


def phase_fleet():
    from repro_torch.fed.fleet import run_fleet

    wl = cnn_fleet_workload()
    clients = wl.make_clients()
    specs, cfg, groups = fleet_setup(wl, clients)
    log_groups(groups)
    kept, launches, out = fleet_main_run(wl, clients, specs, cfg,
                                         FLEET_KERNELS)

    # two more one-round runs, alike but for what watches them: bare
    # (the wall) and under torch.profiler
    def one_round():
        return run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)

    bare_wall, busy, by_name = bare_and_profiled(one_round)
    LANE_RESULTS["fleet_bare_round_s"] = bare_wall     # phase 19 prints it
    log_kernel_time(by_name, busy, "pairwise", "pairwise_l2_kernel")
    log_kernel_time(by_name, busy, "distance-free (5-6)", "from_feats")
    log_kernel_time(by_name, busy, "BUILD over D (2)", "build_cost_walk")
    log_kernel_time(by_name, busy, "Δ-sweep over D (3)", "delta_sweep_")
    return wl, clients, specs, cfg, kept, launches, out


def check_same_rounds(kept, other, rounds, what):
    """The first ``rounds`` rounds of two fleet runs: the same medoids
    per (round, client) and bit-identical parameters after every
    round."""
    import torch

    check(len(other) == rounds, f"{what}: the second run ran "
          f"{len(other)} rounds, not {rounds}")
    for r, ((km, kp), (pm, pp)) in enumerate(zip(kept, other)):
        check(set(km) == set(pm), f"round {r}: other clients selected")
        diff = [c for c in km if not (km[c] == pm[c]).all()]
        check(not diff, f"round {r}: {what} medoids differ for clients "
              f"{diff}")
        same = all(torch.equal(kp[k], pp[k]) for k in kp)
        check(same, f"round {r}: {what} params are not bit-identical")
    log(f"  {sum(len(m) for m, _ in other)} coresets equal per (round, "
        f"client); params bit-identical after every round")


def plain_selection_ab(wl, clients, specs, cfg, kept, rounds):
    """The plain-selection run of the first ``rounds`` rounds: medoids
    equal, params bit-identical after every round.  Returns its launch
    counts."""
    import dataclasses

    _, pkept, _, plaunches, pwall = run_fleet_recorded(
        wl, clients, specs, dataclasses.replace(cfg, use_kernel=False),
        rounds, "batched")
    log(f"  plain run ({rounds} rounds): wall {pwall:.2f} s, launches "
        f"{plaunches}")
    check(all(plaunches[k] == 0 for k in SELECTION_KERNELS),
          f"use_kernel=False launched a selection kernel: {plaunches}")
    check_same_rounds(kept, pkept, rounds, "kernel and plain")
    return plaunches


def loop_round_ab(wl, clients, specs, cfg, kept, params_atol):
    """One loop round against the batched run's first (``kept[0]``):
    medoids equal, params within ``params_atol``.  Returns its launch
    counts."""
    _, lkept, _, llaunches, lwall = run_fleet_recorded(
        wl, clients, specs, cfg, 1, "loop")
    (bm, bp), (lm, lp) = kept[0], lkept[0]
    log(f"  loop round: wall {lwall:.2f} s, launches {llaunches}")
    check(set(bm) == set(lm), "loop round: other clients selected")
    diff = [c for c in bm if not (bm[c] == lm[c]).all()]
    check(not diff, f"loop round: medoids differ from the batched round's "
          f"for clients {diff}")
    max_diff = max(float((bp[k] - lp[k]).abs().max()) for k in bp)
    log(f"  loop vs batched, one round: {len(bm)} coresets equal, params "
        f"max abs diff {max_diff:.3e} (PARAMS_ATOL {params_atol})")
    check(max_diff <= params_atol,
          f"loop and batched params differ by {max_diff:.3e}")
    return llaunches


def phase_fleet_ab(wl, clients, specs, cfg, kept, params_atol, rounds):
    """The plain-selection run of the first ``rounds`` rounds (medoids
    equal, params bit-identical after every round) and one loop round
    (medoids equal, params within ``params_atol``)."""
    plaunches = plain_selection_ab(wl, clients, specs, cfg, kept, rounds)
    llaunches = loop_round_ab(wl, clients, specs, cfg, kept, params_atol)
    return plaunches, llaunches


# ---------------------------------------------------------------------------
# phase 12: the async runtime
# ---------------------------------------------------------------------------

def run_async(model, clients, specs, cfg, use_kernel=None):
    """One ``run_federated_async`` with ``FedCore`` and
    ``FedBuff(buffer_size=10)`` on the card, recording on; returns
    (output, strategy, span records, launch counts, wall seconds)."""
    import torch

    from repro_torch.core.coreset import FedCoreConfig
    from repro_torch.fed import FedBuff, LocalTrainer, run_federated_async
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    strategy = recording_fedcore()(
        LocalTrainer(model, cfg.lr, cfg.batch_size),
        FedCoreConfig(use_kernel=use_kernel))
    init = model.init(torch.Generator().manual_seed(cfg.seed))
    sink = InMemorySink()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(Recorder([sink])):
        out = run_federated_async(model, clients, specs, strategy, cfg,
                                  aggregator=FedBuff(buffer_size=10),
                                  init_params=init)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, strategy, sink.records, dict(ops.LAUNCHES), wall


def log_async(out, records, wall):
    """The run's makespan, staleness histogram, wall by span and
    records."""
    t = out["telemetry"]
    log(f"  wall {wall:.2f} s; makespan {t['makespan']!r} virtual s; "
        f"staleness histogram {t['staleness_hist'].tolist()} (mean "
        f"{t['mean_staleness']:.3f}); {t['n_dispatches']} dispatches, "
        f"{t['n_updates_applied']} updates applied, {t['n_dropped']} "
        f"dropped, {t['n_violations']} violations; client utilization "
        f"{t['client_utilization']:.4f}")
    spans = {}
    for r in records:
        if r["kind"] == "span":
            n, d = spans.get(r["name"], (0, 0.0))
            spans[r["name"]] = (n + 1, d + r["dur"])
    log("  wall by span: " + ", ".join(
        f"{k} {n}x {d:.3f} s ({100 * d / wall:.1f}%)"
        for k, (n, d) in sorted(spans.items(), key=lambda kv: -kv[1][1])))
    for h in out["history"]:
        log(f"  record {h.round}: sim_round_time {h.sim_round_time!r} "
            f"n_participants {h.n_participants} n_coreset {h.n_coreset} "
            f"train_loss {h.train_loss:.4f}")
    return {r["attrs"].get("device") for r in records
            if r["kind"] == "span" and r["name"] == "selection"}


def phase_async(clients):
    """Phase 12: ``run_federated_async`` at full width, its plain A/B and
    one ``run_scenario("pareto", "async")``; returns the main run's
    launch counts."""
    import numpy as np

    from repro_torch.fed import AsyncFLConfig, make_client_specs
    from repro_torch.fed.fleet import SCENARIOS, run_scenario
    from repro_torch.kernels import ops
    from repro_torch.models import SmallCNN
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    specs = make_client_specs([len(d["y"]) for d in clients],
                              np.random.default_rng(0))
    cfg = AsyncFLConfig(max_updates=3, concurrency=10, epochs=5,
                        batch_size=8, lr=0.03, straggler_pct=30.0,
                        record_every=1)
    kout, kstrat, records, launches, wall = run_async(SmallCNN(), clients,
                                                      specs, cfg)
    devices = log_async(kout, records, wall)
    log(f"  launches on the async path: {launches}; {len(kstrat.selected)} "
        f"coresets, budgets {[b for _, b, _ in kstrat.selected]}")
    check(kout["telemetry"]["n_updates_applied"] == 3,
          "the async run applied another number of updates")
    check(len(kstrat.selected) > 0, "the async run built no coreset")
    check(all(launches[k] > 0 for k in SYNC_KERNELS),
          f"a kernel never launched on the async path: {launches}")
    check(all(str(d).startswith("cuda") for d in devices),
          f"an async coreset was built off the card: {devices}")
    check_params(kout)

    pout, pstrat, _, plaunches, pwall = run_async(SmallCNN(), clients,
                                                  specs, cfg,
                                                  use_kernel=False)
    log(f"  plain run: wall {pwall:.2f} s, launches {plaunches}")
    check(all(n == 0 for n in plaunches.values()),
          f"use_kernel=False launched a kernel: {plaunches}")
    check(pout["event_log"] == kout["event_log"],
          "the plain run's event log differs from the kernel run's")
    log(f"  event logs equal byte for byte ({len(kout['event_log'])} "
        f"events)")
    check_plain_selections(kout, kstrat, pout, pstrat)

    sink = InMemorySink()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(Recorder([sink])):
        sout = run_scenario("pareto", "async", model=SmallCNN(),
                            clients_data=clients, aggregator="delayed_grad",
                            max_updates=20)
    swall = time.perf_counter() - t0
    slaunches = dict(ops.LAUNCHES)
    log(f"  run_scenario('pareto', 'async', delayed_grad, max_updates=20): "
        f"capability trace {SCENARIOS['pareto'].trace_config(0)}")
    log_async(sout, sink.records, swall)
    log(f"  launches: {slaunches}")
    check(sout["aggregator"] == "delayed_grad" and
          sout["telemetry"]["n_updates_applied"] == 20,
          "the scenario's async run did not apply 20 delayed gradients")
    check_params(sout)
    return launches


# ---------------------------------------------------------------------------
# phase 13: faults on the CNN fleet
# ---------------------------------------------------------------------------

def expected_fault_stats(profile, n, seed, rounds):
    """Each round's (cohort, dropped, corrupted) as the ``FaultTrace`` of
    ``profile`` says a fleet of every present client gives them."""
    import numpy as np

    from repro_torch.fed.fleet import FAULT_PROFILES, FaultTrace

    ft = FaultTrace(FAULT_PROFILES[profile], n, seed=seed)
    counts = np.zeros(n, np.int64)
    out = []
    for r in range(rounds):
        cohort = np.nonzero(ft.present_mask(r))[0]
        dropped = {int(c): ft.dropped(int(c), int(counts[c]))
                   for c in cohort}
        corrupt = {int(c): bool(ft.byzantine[c]) and not dropped[int(c)]
                   for c in cohort}
        counts[cohort] += 1
        out.append((set(int(c) for c in cohort), dropped, corrupt))
    return out


def phase_fleet_faults(wl, clients, specs, cfg, sync_clients):
    """Phase 13: the CNN fleet under ``hostile`` with the trimmed mean, its
    plain A/B, one round of each other robust rule under
    ``byzantine_boost``, and a faulted sync scenario; returns the faulted
    fleet's launch counts."""
    import dataclasses

    import torch

    from repro_torch.fed.fleet import run_fleet, run_scenario
    from repro_torch.kernels import ops
    from repro_torch.models import SmallCNN
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    rounds = 2
    tcfg = dataclasses.replace(cfg, aggregator="trimmed_mean")
    stats = []
    out, kept, records, launches, wall = run_fleet_recorded(
        wl, clients, specs, tcfg, rounds, "batched", faults="hostile",
        stats=stats)
    report_fleet_rounds(records)
    for h in out["history"]:
        log(f"  round {h.round}: n_participants {h.n_participants} "
            f"n_dropped {h.n_dropped} n_coreset {h.n_coreset} "
            f"sim_round_time {h.sim_round_time:.4f} train_loss "
            f"{h.train_loss:.4f}")
    log(f"  wall {wall:.2f} s; launches on the faulted fleet path: "
        f"{launches}")
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched under faults: {launches}")
    want = expected_fault_stats("hostile", len(specs), cfg.seed, rounds)
    for r, (st, (cohort, dropped, corrupt)) in enumerate(zip(stats, want)):
        got_d = {int(c): bool(d) for c, d in zip(st.cids, st.dropped)}
        got_c = {int(c): bool(x) for c, x in zip(st.cids, st.corrupted)}
        check(set(got_d) == cohort, f"round {r}: the cohort is not the "
              f"FaultTrace's present clients")
        check(got_d == dropped and got_c == corrupt,
              f"round {r}: dropped / corrupted stats differ from the "
              f"FaultTrace's")
        log(f"  round {r}: {len(cohort)} present, {sum(dropped.values())} "
            f"dropped, {sum(corrupt.values())} corrupted, as the "
            f"FaultTrace draws them")
    check_params(out)

    _, pkept, _, plaunches, pwall = run_fleet_recorded(
        wl, clients, specs, dataclasses.replace(tcfg, use_kernel=False),
        rounds, "batched", faults="hostile")
    log(f"  plain run ({rounds} rounds): wall {pwall:.2f} s, launches "
        f"{plaunches}")
    check(all(plaunches[k] == 0 for k in SELECTION_KERNELS),
          f"use_kernel=False launched a selection kernel: {plaunches}")
    check_same_rounds(kept, pkept, rounds, "faulted kernel and plain")

    for method in ("median", "krum", "multi_krum", "norm_clip"):
        rec = Recorder([InMemorySink()])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_recorder(rec):
            mout = run_fleet(wl, clients, specs,
                             dataclasses.replace(cfg, aggregator=method), 1,
                             straggler_pct=30.0, faults="byzantine_boost")
        torch.cuda.synchronize()
        n_bad = rec.metrics.snapshot()["counters"].get(
            "faults.corrupted_updates", 0)
        log(f"  {method} under byzantine_boost, one round: wall "
            f"{time.perf_counter() - t0:.2f} s, {n_bad} corrupted updates, "
            f"train_loss {mout['history'][0].train_loss:.4f}")
        check(n_bad > 0, f"{method}: no update was corrupted")
        check_params(mout)

    rec = Recorder([InMemorySink()])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with use_recorder(rec):
        sout = run_scenario("uniform", "sync", model=SmallCNN(),
                            clients_data=sync_clients, rounds=2,
                            faults="byzantine_noise", aggregator="median")
    counters = rec.metrics.snapshot()["counters"]
    log(f"  run_scenario('uniform', 'sync', byzantine_noise, median), 2 "
        f"rounds: wall {time.perf_counter() - t0:.2f} s, "
        f"{counters.get('faults.corrupted_updates', 0)} corrupted updates, "
        f"launches {dict(ops.LAUNCHES)}")
    check(sout["faults"] == "byzantine_noise", "the scenario lost its faults")
    check_params(sout)
    return launches


# ---------------------------------------------------------------------------
# phase 14: the async fleet engine on the CNN fleet
# ---------------------------------------------------------------------------

# phase 14's main run: 3 flushes of 32 completions, 64 clients in flight
ASYNC_FLEET = dict(max_updates=3, buffer_k=32, concurrency=64, epochs=5,
                   batch_size=8, lr=0.03, straggler_pct=30.0, seed=0)
# the spans of a flush (and of the windows between flushes) whose wall
# phase 14 prints
ASYNC_FLEET_SPANS = ("cohort_build", "dispatch", "aggregate", "gather",
                     "dispatch_wave", "buffer_fill")


@contextlib.contextmanager
def async_fleet_recording():
    """Record, while open, each flush's cohort groups as (M, k, C), the
    medoids of each group (batched, loop or sharded) as (flush, {cid:
    indices}) in run order, and
    the device of every stack ``robust_combine`` merges: a dict with
    ``groups``, ``medoids`` and ``robust_devices``."""
    import numpy as np

    import repro_torch.fed.fleet.async_engine as async_engine
    from repro_torch.fed.fleet import FleetEngine, ShardedFleetEngine

    rec = {"groups": {}, "medoids": [], "robust_devices": []}
    current = [0]
    make_groups = async_engine.make_cohort_groups
    run_group = FleetEngine.run_group
    run_sharded = ShardedFleetEngine.run_group_sharded
    combine = async_engine.robust_combine

    def recording_groups(*args, round_seed=0, **kwargs):
        groups = make_groups(*args, round_seed=round_seed, **kwargs)
        current[0] = round_seed
        rec["groups"].setdefault(round_seed, []).extend(
            (g.valid.shape[1], g.k, g.n_clients) for g in groups)
        return groups

    def recording_run_group(self, params, group, batched=True):
        p, losses, meds = run_group(self, params, group, batched)
        if meds is not None:
            rec["medoids"].append((current[0], {
                int(c): np.asarray(m) for c, m in zip(group.cids, meds)}))
        return p, losses, meds

    def recording_run_sharded(self, params, group, weights,
                              gather_stack=False):
        out = run_sharded(self, params, group, weights, gather_stack)
        if out[3] is not None:
            rec["medoids"].append((current[0], {
                int(c): np.asarray(m) for c, m in zip(group.cids, out[3])}))
        return out

    def recording_combine(stacked, *args, **kwargs):
        rec["robust_devices"].append(
            str(next(iter(stacked.values())).device))
        return combine(stacked, *args, **kwargs)

    async_engine.make_cohort_groups = recording_groups
    FleetEngine.run_group = recording_run_group
    ShardedFleetEngine.run_group_sharded = recording_run_sharded
    async_engine.robust_combine = recording_combine
    try:
        yield rec
    finally:
        async_engine.make_cohort_groups = make_groups
        FleetEngine.run_group = run_group
        ShardedFleetEngine.run_group_sharded = run_sharded
        async_engine.robust_combine = combine


def run_async_fleet_recorded(wl, clients, specs, cfg, engine="batched",
                             **kwargs):
    """One ``run_async_fleet`` on the card with recording on; returns
    (output, ``async_fleet_recording``'s record, span records, launch
    counts, wall seconds)."""
    import torch

    from repro_torch.fed.fleet import run_async_fleet
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    sink = InMemorySink()
    with async_fleet_recording() as rec:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(Recorder([sink])):
            out = run_async_fleet(wl, clients, specs, cfg, engine=engine,
                                  **kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    return out, rec, sink.records, launches, wall


def log_async_fleet(out, rec, records, wall):
    """Each flush's groups and wall, the makespan, the staleness and
    occupancy histograms, the dispatch counts and the wall by span."""
    t = out["telemetry"]
    for f, groups in sorted(rec["groups"].items()):
        log(f"  flush {f} groups (M, k, C): " + ", ".join(
            f"({m}, {k}, {c})" for m, k, c in groups))
    spans = [r for r in records if r["kind"] == "span"]
    log("  flush window walls s (wave to merge): " + ", ".join(
        f"{r['dur']:.3f}" for r in spans if r["name"] == "round"))
    log(f"  wall {wall:.2f} s; makespan {t['makespan']!r} virtual s; "
        f"staleness histogram {t['staleness_hist'].tolist()} (mean "
        f"{t['mean_staleness']:.3f}); buffer occupancy histogram "
        f"{t['buffer_occupancy_hist'].tolist()}; "
        f"{t['n_group_dispatches']} group dispatches for "
        f"{t['n_dispatches']} client dispatches; {t['n_merged_clients']} "
        f"merged, {t['n_partial_flushes']} partial flushes, "
        f"{t['n_violations']} violations")
    by_name = {}
    for r in spans:
        if r["name"] in ASYNC_FLEET_SPANS:
            n, d = by_name.get(r["name"], (0, 0.0))
            by_name[r["name"]] = (n + 1, d + r["dur"])
    log("  wall by span: " + ", ".join(
        f"{k} {by_name.get(k, (0, 0.0))[0]}x "
        f"{by_name.get(k, (0, 0.0))[1]:.3f} s "
        f"({100 * by_name.get(k, (0, 0.0))[1] / wall:.1f}%)"
        for k in ASYNC_FLEET_SPANS))
    for h in out["history"]:
        log(f"  flush {h.round}: n_participants {h.n_participants} "
            f"n_coreset {h.n_coreset} n_dropped {h.n_dropped} "
            f"sim_round_time {h.sim_round_time:.4f} train_loss "
            f"{h.train_loss:.4f}")


def check_same_medoids(got, want, what):
    """The medoids of two async fleet runs per (flush, client)."""
    check(len(got) == len(want) and all(
        gf == wf and set(gm) == set(wm) for (gf, gm), (wf, wm)
        in zip(got, want)), f"{what}: other flushes or clients selected")
    diff = [(f, c) for (f, gm), (_, wm) in zip(got, want) for c in gm
            if not (gm[c] == wm[c]).all()]
    check(not diff, f"{what}: medoids differ for (flush, client) {diff}")


def expected_async_faults(profile, n, seed, event_log):
    """(dropped, corrupted) as the ``FaultTrace`` of ``profile`` draws
    them for the completions of an async fleet's event log: each
    completion's dispatch ordinal counts its client's dispatches before
    it, a dropped completion is lost, and every other completion's
    Byzantine client is corrupted when its flush merges (every completed
    update merges: the run ends on a flush)."""
    import numpy as np

    from repro_torch.fed.fleet import FAULT_PROFILES, FaultTrace

    ft = FaultTrace(FAULT_PROFILES[profile], n, seed=seed)
    counts = np.zeros(n, np.int64)
    dropped = corrupted = 0
    for line in event_log:
        kind, cid = line.split()[2], int(line.split()[3][len("cid="):])
        if kind == "dispatch":
            counts[cid] += 1
        elif ft.dropped(cid, int(counts[cid]) - 1):
            dropped += 1
        else:
            corrupted += int(ft.byzantine[cid])
    return dropped, corrupted


def phase_async_fleet(wl, clients, specs):
    """Phase 14: ``run_async_fleet`` on phase 6's CNN fleet, its plain
    twin, the loop engine at one flush and a faulted ``async_fleet``
    scenario with the trimmed mean; returns the main run's launch counts
    and output."""
    import dataclasses

    import torch

    from repro_torch.fed.fleet import AsyncFleetConfig, run_scenario
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    cfg = AsyncFleetConfig(**ASYNC_FLEET)
    out, rec, records, launches, wall = run_async_fleet_recorded(
        wl, clients, specs, cfg, aggregator="fedbuff")
    log_async_fleet(out, rec, records, wall)
    log(f"  launches on the async fleet path: {launches}")
    check(out["applied"] == cfg.max_updates,
          f"the async fleet applied {out['applied']} flushes")
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched on the async fleet path: "
          f"{launches}")
    big = [g for gs in rec["groups"].values() for g in gs
           if g[1] > 0 and g[0] >= 256]
    check(bool(big), "no straggler group of the async fleet reached "
          "M = 256")
    check(out["telemetry"]["max_staleness"] >= 1,
          "no update of staleness > 0 was merged")
    check_params(out)
    pwall, busy, _ = device_busy_share(lambda: run_async_fleet_recorded(
        wl, clients, specs, cfg, aggregator="fedbuff"))
    if busy is None:
        log("  device busy share: not measured (the profiler saw no "
            "device activity)")
    else:
        log(f"  device busy (the same run under torch.profiler, wall "
            f"{pwall:.3f} s): busy {busy:.3f} s; idle "
            f"{100 * (1 - busy / wall):.1f}% of the main run's wall "
            f"{wall:.3f} s")

    pout, prec, _, plaunches, pwall = run_async_fleet_recorded(
        wl, clients, specs, dataclasses.replace(cfg, use_kernel=False),
        aggregator="fedbuff")
    log(f"  plain twin: wall {pwall:.2f} s, launches {plaunches}")
    check(all(plaunches[k] == 0 for k in SELECTION_KERNELS),
          f"use_kernel=False launched a selection kernel: {plaunches}")
    check(pout["event_log"] == out["event_log"],
          "the plain twin's event log differs")
    check_same_medoids(prec["medoids"], rec["medoids"], "kernel and plain")
    check(all(torch.equal(v, pout["params"][k])
              for k, v in out["params"].items()),
          "the plain twin's params are not bit-identical")
    log(f"  event logs equal byte for byte ({len(out['event_log'])} "
        f"events); {sum(len(m) for _, m in rec['medoids'])} coresets equal "
        f"per (flush, client); params bit-identical")

    one = dataclasses.replace(cfg, max_updates=1)
    bout, brec, _, _, bwall = run_async_fleet_recorded(
        wl, clients, specs, one, aggregator="fedbuff")
    lout, lrec, _, llaunches, lwall = run_async_fleet_recorded(
        wl, clients, specs, one, engine="loop", aggregator="fedbuff")
    check(lout["event_log"] == bout["event_log"],
          "the loop engine's event log differs from the batched one's")
    check_same_medoids(lrec["medoids"], brec["medoids"], "loop and batched")
    max_diff = max(float((bout["params"][k] - v).abs().max())
                   for k, v in lout["params"].items())
    log(f"  one flush: batched wall {bwall:.2f} s, loop wall {lwall:.2f} s "
        f"(launches {llaunches}, {lout['telemetry']['n_group_dispatches']} "
        f"dispatches against {bout['telemetry']['n_group_dispatches']}); "
        f"event logs equal, params max abs diff {max_diff:.3e} "
        f"(PARAMS_ATOL {PARAMS_ATOL_CNN})")
    check(max_diff <= PARAMS_ATOL_CNN,
          f"loop and batched params differ by {max_diff:.3e}")

    recorder = Recorder([InMemorySink()])
    with async_fleet_recording() as srec:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(recorder):
            sout = run_scenario("pareto", "async_fleet", model=wl,
                                clients_data=clients, faults="hostile",
                                aggregator="trimmed_mean", max_updates=2,
                                clients_per_round=16)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
    st = sout["telemetry"]
    want = expected_async_faults("hostile", len(clients), 0,
                                 sout["event_log"])
    counters = recorder.metrics.snapshot()["counters"]
    log(f"  run_scenario('pareto', 'async_fleet', hostile, trimmed_mean, "
        f"max_updates=2, clients_per_round=16): wall {swall:.2f} s, "
        f"{st['n_dropped_updates']} dropped and "
        f"{st['n_corrupted_updates']} corrupted updates (FaultTrace "
        f"replay {want}), {sout['applied']} flushes "
        f"({st['n_partial_flushes']} partial), robust merges on "
        f"{srec['robust_devices']}, "
        f"launches {dict(ops.LAUNCHES)}")
    check((st["n_dropped_updates"], st["n_corrupted_updates"]) == want,
          "the scenario's dropped / corrupted counts are not the "
          "FaultTrace's")
    check((counters.get("faults.dropped_updates", 0),
           counters.get("faults.corrupted_updates", 0)) == want,
          "the fault counters differ from the FaultTrace's")
    # a buffer of 16 with 16 in flight fills only while no update is
    # lost: after a dropout the run ends on a partial flush
    check(sout["aggregator"] == "trimmed_mean" and sout["applied"] >= 1,
          "the scenario applied no trimmed-mean flush")
    check(len(srec["robust_devices"]) == sout["applied"] and all(
        d.startswith("cuda") for d in srec["robust_devices"]),
        f"a robust merge ran off the card: {srec['robust_devices']}")
    check_params(sout)
    return launches, out


# ---------------------------------------------------------------------------
# phase 15: checkpoint and resume, the projected sync round, the ε audit
# ---------------------------------------------------------------------------

# (c)'s JL width and rounds; (d)'s coreset budget and projection widths
# (benchmarks/perf_h3_projection.py's; None is the full F = 1568)
PROJECTION_DIM = 256
PROJECTED_ROUNDS = 1
EPS_BUDGET = 24
EPS_DIMS = (None, 256, 64, 16)
CKPT_DIR = LANE_DIR / "checkpoints"


def history_text(history):
    """A run's history as JSON text: equal records give equal text, NaN
    fields included."""
    import dataclasses

    return json.dumps([dataclasses.asdict(h) for h in history])


def log_checkpoints(records, directory, wall, what):
    """The checkpointed run's wall, its ``checkpoint`` spans and the
    files it left."""
    spans = [r["dur"] for r in records
             if r["kind"] == "span" and r["name"] == "checkpoint"]
    files = sorted(directory.iterdir())
    log(f"  {what}: wall {wall:.2f} s; {len(spans)} checkpoints of "
        + ", ".join(f"{1e3 * d:.1f}" for d in spans) + " ms; "
        + ", ".join(f"{f.name} {f.stat().st_size} B" for f in files))
    check(bool(spans) and any(f.suffix == ".npz" for f in files),
          f"{what}: no checkpoint was written")


def resumed_at(records):
    return [r["data"]["round"] for r in records
            if r["kind"] == "event" and r["name"] == "resume"]


def phase_fleet_resume(wl, clients, specs, cfg, fout):
    """(a) phase 6's fleet: 2 rounds checkpointed every round, then
    ``resume=True`` to 3, against phase 6's 3 uninterrupted rounds: the
    same history and bit-identical params; the resumed round launches
    every fleet kernel.  Returns its launch counts."""
    import shutil

    import torch

    d = CKPT_DIR / "fleet"
    shutil.rmtree(d, ignore_errors=True)
    _, _, crecords, _, cwall = run_fleet_recorded(
        wl, clients, specs, cfg, 2, "batched", checkpoint_dir=str(d),
        checkpoint_every=1)
    log_checkpoints(crecords, d, cwall, "(a) 2 rounds, checkpoint_every=1")
    out, kept, records, launches, wall = run_fleet_recorded(
        wl, clients, specs, cfg, 3, "batched", checkpoint_dir=str(d),
        resume=True)
    log(f"  (a) resume=True to 3 rounds: resumed at round "
        f"{resumed_at(records)}, wall {wall:.2f} s, launches {launches}")
    check(resumed_at(records) == [2] and len(kept) == 1,
          f"the fleet did not resume at round 2: {resumed_at(records)}")
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched in the resumed round: {launches}")
    check(history_text(out["history"]) == history_text(fout["history"]),
          "the resumed fleet's history differs from phase 6's")
    check(all(torch.equal(v, out["params"][k])
              for k, v in fout["params"].items()),
          "the resumed fleet's params are not phase 6's bit for bit")
    check_params(out)
    log(f"  (a) history equal to phase 6's ({len(out['history'])} rounds), "
        f"params bit-identical")
    return launches


def phase_async_fleet_resume(wl, clients, specs, aout):
    """(b) phase 14's async fleet: 1 flush checkpointed, then
    ``resume=True`` to 3, against phase 14 (a): the same event log and
    history, bit-identical params.  Returns the resumed run's launch
    counts."""
    import dataclasses
    import shutil

    import torch

    from repro_torch.fed.fleet import AsyncFleetConfig

    cfg = AsyncFleetConfig(**ASYNC_FLEET)
    d = CKPT_DIR / "async_fleet"
    shutil.rmtree(d, ignore_errors=True)
    _, _, crecords, _, cwall = run_async_fleet_recorded(
        wl, clients, specs, dataclasses.replace(cfg, max_updates=1),
        aggregator="fedbuff", checkpoint_dir=str(d), checkpoint_every=1)
    log_checkpoints(crecords, d, cwall, "(b) 1 flush, checkpoint_every=1")
    out, _, records, launches, wall = run_async_fleet_recorded(
        wl, clients, specs, cfg, aggregator="fedbuff",
        checkpoint_dir=str(d), resume=True)
    log(f"  (b) resume=True to {cfg.max_updates} flushes: resumed at flush "
        f"{resumed_at(records)}, wall {wall:.2f} s, launches {launches}")
    check(resumed_at(records) == [1] and out["applied"] == cfg.max_updates,
          f"the async fleet did not resume at flush 1: "
          f"{resumed_at(records)}")
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched after the resume: {launches}")
    check(out["event_log"] == aout["event_log"],
          "the resumed async fleet's event log differs from phase 14's")
    check(history_text(out["history"]) == history_text(aout["history"]),
          "the resumed async fleet's history differs from phase 14's")
    check(all(torch.equal(v, out["params"][k])
              for k, v in aout["params"].items()),
          "the resumed async fleet's params are not phase 14's bit for bit")
    check_params(out)
    log(f"  (b) event log equal to phase 14's ({len(out['event_log'])} "
        f"events), history equal, params bit-identical")
    return launches


def phase_projected_sync(clients, cfg):
    """(c) phase 3's run at ``FedCoreConfig(projection_dim=256)`` for
    ``PROJECTED_ROUNDS`` rounds, kernels 1-3 at F' = 256, and its
    ``use_kernel=False`` twin: equal coresets per (round, client),
    bit-identical params.  Returns the kernel run's launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import SmallCNN

    pcfg = dataclasses.replace(cfg, rounds=PROJECTED_ROUNDS)
    kout, kstrat, records, launches, wall = run_fl(
        SmallCNN(), clients, pcfg, projection_dim=PROJECTION_DIM)
    devices, sel_s, round_s = report_rounds(kout, records)
    log(f"  (c) projection_dim={PROJECTION_DIM}, {PROJECTED_ROUNDS} "
        f"round(s): wall {wall:.2f} s; selection {sel_s:.3f} s of "
        f"{round_s:.3f} s in rounds; {len(kstrat.selected)} coresets, "
        f"budgets {[b for _, b, _ in kstrat.selected]} of m "
        f"{[len(f) for f, _, _ in kstrat.selected]}; launches {launches}")
    check(len(kstrat.selected) > 0, "the projected run built no coreset")
    check(all(launches[k] > 0 for k in SYNC_KERNELS),
          f"a kernel never launched on the projected round: {launches}")
    check(all(str(d).startswith("cuda") for d in devices),
          f"a projected coreset was built off the card: {devices}")
    pout, pstrat, _, plaunches, pwall = run_fl(
        SmallCNN(), clients, pcfg, use_kernel=False,
        projection_dim=PROJECTION_DIM)
    log(f"  (c) plain twin: wall {pwall:.2f} s, launches {plaunches}")
    check(all(n == 0 for n in plaunches.values()),
          f"use_kernel=False launched a kernel: {plaunches}")
    check(len(pstrat.selected) == len(kstrat.selected),
          "the plain twin built another number of coresets")
    diff = [i for i, (a, b) in enumerate(zip(kstrat.selected,
                                             pstrat.selected))
            if not np.array_equal(a[2], b[2])]
    check(not diff, f"kernel and plain coresets differ at selections {diff}")
    check(all(torch.equal(v, pout["params"][k])
              for k, v in kout["params"].items()),
          "the projected run's params are not its plain twin's bit for bit")
    check_params(kout)
    log(f"  (c) {len(kstrat.selected)} coresets equal per (round, client), "
        f"params bit-identical")
    return launches


def phase_epsilon_audit(clients, params):
    """(d) the ε of Assumption A.3 on the card: one phase-3 client with m
    >= 160, exact per-sample gradients of the full SmallCNN at phase 3's
    final params, ε of a budget-24 coreset at each of ``EPS_DIMS`` with
    its selection wall, and ε at the full budget below 1e-5 relative to
    ‖Σg‖/m."""
    import torch

    from repro_torch.core import (build_coreset, coreset_epsilon,
                                  grad_features, true_per_sample_grads)
    from repro_torch.models import SmallCNN

    cid = next(i for i, d in enumerate(clients) if len(d["y"]) >= 160)
    data, model = clients[cid], SmallCNN()
    m = len(data["y"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads = true_per_sample_grads(model.loss, params, data)
    gwall = time.perf_counter() - t0
    n_params = sum(v.numel() for v in params.values())
    check(grads.shape == (m, n_params),
          f"per-sample gradients of shape {grads.shape}")
    g = torch.as_tensor(grads, device=next(iter(params.values())).device)
    scale = float(torch.linalg.vector_norm(g.sum(0))) / m
    log(f"  (d) client {cid}, m = {m}: true_per_sample_grads ({m}, "
        f"{n_params}) in {gwall:.3f} s; ‖Σg‖/m = {scale:.6e}")
    feats = grad_features(model, params, data)
    build_coreset(feats, EPS_BUDGET)            # warm: the first launches
    base = None
    for dim in EPS_DIMS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs = build_coreset(feats, EPS_BUDGET, projection_dim=dim)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eps = float(coreset_epsilon(g, cs))
        idx = set(cs.indices.tolist())
        base = idx if base is None else base
        log(f"  (d) F' = {dim or feats.shape[1]}: ε = {eps:.6e} "
            f"({eps / scale:.4f} of ‖Σg‖/m), overlap with the full-width "
            f"coreset {100 * len(idx & base) / EPS_BUDGET:.0f}%, selection "
            f"{1e3 * wall:.2f} ms")
    full = build_coreset(feats, m)
    eps_full = float(coreset_epsilon(g, full))
    log(f"  (d) full budget (k = m = {m}): ε = {eps_full:.3e} "
        f"({eps_full / scale:.3e} of ‖Σg‖/m)")
    check(eps_full / scale < 1e-5,
          f"ε at the full budget is {eps_full / scale:.3e} of ‖Σg‖/m")


# ---------------------------------------------------------------------------
# phases 8-9: the translm fleet
# ---------------------------------------------------------------------------

def translm_fleet():
    """The registry's ``translm`` workload over 200 char-LM clients at the
    paper's Table-1 sizes (lognormal, mean 69, std 106); returns (workload,
    clients, specs, config, round-0 groups)."""
    from repro_torch.fed.fleet import get_workload

    wl = get_workload("translm")
    clients = char_lm_clients()
    return (wl, clients) + fleet_setup(wl, clients)


def translm_attention_shapes(cfg, groups):
    """(B, label, shape key) of the fleet's attention calls: the vmapped
    SGD step of the largest group (C clients x B samples) and the feature
    pass of the largest straggler (M samples)."""
    c = max(g.n_clients for g in groups)
    m = max(g.valid.shape[1] for g in groups if g.k > 0)
    return [(c * cfg.batch_size, f"translm step, C={c}", "translm step"),
            (m, f"translm features, M={m}", "translm features")]


def phase_translm(wl, clients, specs, cfg, groups):
    import torch

    from repro_torch.fed.fleet import run_fleet

    log_groups(groups)
    kept, launches, _ = fleet_main_run(wl, clients, specs, cfg,
                                       FLEET_KERNELS + ("flash_attention",
                                                        "rmsnorm"))

    def one_round():
        return run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)

    _, busy, by_name = bare_and_profiled(one_round, top=10)
    log_kernel_time(by_name, busy, "flash-attention", "flash_attention")
    log_kernel_time(by_name, busy, "pairwise", "pairwise_l2_kernel")
    log_kernel_time(by_name, busy, "distance-free (5-6)", "from_feats")
    log_kernel_time(by_name, busy, "BUILD over D (2)", "build_cost_walk")
    log_kernel_time(by_name, busy, "Δ-sweep over D (3)", "delta_sweep_")
    step_host_breakdown(wl, cfg, groups, torch.device("cuda"))
    return kept, launches


def step_host_breakdown(wl, cfg, groups, dev, n_steps=30, n_prof=5,
                        kernel=None):
    """Where a vmapped SGD step of a char-LM fleet spends its wall: for
    the straggler group with the most samples and the group with the most
    clients, the wall per step over ``n_steps`` steps (perf_counter,
    synchronised at both ends), then ``n_prof`` steps under
    ``torch.profiler`` (host and device): ATen calls, kernel launches and
    device busy time per step, and the ATen ops with the most host self
    time.  Also counts the vmap fallback's warnings over one step (an op
    without a batching rule runs once per client).  With ``kernel``, the
    timed steps must each have launched that kernel of ``ops``."""
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fed.fleet.batched import FleetEngine
    from repro_torch.kernels import ops

    eng = FleetEngine(wl.model, cfg, device=dev)
    params = wl.init(torch.Generator().manual_seed(0), dev)
    picks = {"straggler, most samples": max(
                 (g for g in groups if g.k > 0),
                 key=lambda g: g.valid.shape[1]),
             "most clients": max(groups, key=lambda g: g.n_clients)}
    for what, g in picks.items():
        c = g.n_clients
        data = {f: torch.as_tensor(v, device=dev) for f, v in g.data.items()}
        w = torch.as_tensor(g.valid.astype("float32"), device=dev)
        idx = eng._batch_indices(g, slice(None))
        n_t = idx.shape[1]
        p = {k: v.expand((c,) + v.shape) for k, v in params.items()}

        def steps(n, p=p, data=data, w=w, idx=idx, n_t=n_t):
            for t in range(n):
                p, _ = eng._vm_sgd_step(p, data, w, idx[:, t % n_t])
            return p

        steps(3)
        torch._C._functorch._set_vmap_fallback_warning_enabled(True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            steps(1)
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
        fallbacks = [str(x.message) for x in caught
                     if "batching rule" in str(x.message)]
        torch.cuda.synchronize()
        before = ops.LAUNCHES[kernel] if kernel else 0
        t0 = time.perf_counter()
        steps(n_steps)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n_steps * 1e3
        if kernel:
            n_k = ops.LAUNCHES[kernel] - before
            check(n_k >= n_steps, f"{n_steps} vmapped steps launched the "
                  f"{kernel} kernel {n_k} times")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps(n_prof)
            torch.cuda.synchronize()
        events = prof.key_averages()
        aten = [e for e in events if e.key.startswith("aten::")]
        n_aten = sum(e.count for e in aten) / n_prof
        n_launch = sum(e.count for e in events
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC",
                                    "cuLaunchKernelEx")) / n_prof
        host_self = sum(e.self_cpu_time_total for e in events
                        if e.device_type == DeviceType.CPU) / n_prof / 1e3
        dev_busy = sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA) / n_prof / 1e3
        launch_ms = sum(e.self_cpu_time_total for e in events
                        if e.key.startswith(("cudaLaunch", "cuLaunch"))
                        ) / n_prof / 1e3
        # kernels 7 and 8: their device time a step
        ours = {k: sum(e.self_device_time_total for e in events
                       if e.device_type == DeviceType.CUDA and k in e.key)
                / n_prof / 1e3 for k in ("flash_attention", "rmsnorm")}
        log(f"  one vmapped SGD step, {what} (M={g.valid.shape[1]}, "
            f"C={c}): wall {ms:.3f} ms a step over {n_steps} steps; under "
            f"the profiler, a step makes {n_aten:.0f} ATen calls (nested "
            f"ones counted) and {n_launch:.0f} kernel launches "
            f"({launch_ms:.3f} ms of host time in the launch calls), "
            f"host self time of the recorded events {host_self:.3f} ms, "
            f"device busy {dev_busy:.3f} ms, of which kernel 7 (flash "
            f"attention) {ours['flash_attention']:.4f} ms and kernel 8 "
            f"(RMSNorm) {ours['rmsnorm']:.4f} ms; vmap fallback warnings in "
            f"one step: {len(fallbacks)}"
            + (f" ({sorted(set(fallbacks))[0][:160]})" if fallbacks else ""))
        log("    host self time by ATen op, a step: " + "; ".join(
            f"{e.key} {e.count / n_prof:.0f} calls "
            f"{e.self_cpu_time_total / n_prof / 1e3:.3f} ms"
            for e in sorted(aten, key=lambda e: -e.self_cpu_time_total)[:10]))


def attention_kernel_vs_naive(wl, groups, dev):
    """Phase 9 (c): at one batch (B = 8) of each client of the largest
    group, on the initial params, the kernel path against
    ``impl="naive"``: logits within 1e-4 and each parameter's gradient
    (through the vmapped SGD step's ``vmap(grad(...))``) within
    1e-5·max|g| of that parameter."""
    import torch
    from torch.func import grad, vmap

    from repro_torch.fed.fleet.workloads import CharTransformer
    from repro_torch.kernels import ops

    g = max(groups, key=lambda gr: gr.n_clients)
    batch = {f: torch.as_tensor(v[:, :8], device=dev)
             for f, v in g.data.items()}
    params = wl.init(torch.Generator().manual_seed(0), dev)
    m = wl.model
    res = {}
    for uk in (True, False):
        model = CharTransformer(vocab=m.vocab, d_model=m.cfg.d_model,
                                n_heads=m.cfg.n_heads, d_ff=m.d_ff,
                                use_kernel=uk)
        ops.reset_launch_counts()
        logits = model.logits(params, batch["x"].reshape(-1, 16))
        grads = vmap(grad(lambda p, b: model.loss(p, b)[0]),
                     in_dims=(None, 0))(params, batch)
        torch.cuda.synchronize()
        res[uk] = (logits, grads, ops.LAUNCHES["flash_attention"])
    (lk, gk, nk), (ln, gn, nn) = res[True], res[False]
    check(nk == 2 and nn == 0, f"kernel launches {nk} (kernel path) and "
          f"{nn} (naive path); expected 2 and 0")
    dlog = float((lk - ln).abs().max())
    worst = max(float((gk[k] - gn[k]).abs().max())
                / max(float(gn[k].abs().max()), 1e-30) for k in gn)
    log(f"  (c) kernel vs naive attention at C={g.n_clients} x B=8: logits "
        f"max abs diff {dlog:.3e} (limit 1e-4), gradients worst "
        f"max|dg|/max|g| {worst:.3e} (limit 1e-5)")
    check(dlog <= 1e-4, f"logits differ by {dlog:.3e}")
    check(worst <= 1e-5, f"gradients differ by {worst:.3e} of max|g|")


# ---------------------------------------------------------------------------
# phases 10-11: the xlstm fleet
# ---------------------------------------------------------------------------

def xlstm_fleet(clients):
    """The registry's ``xlstm`` workload over phase 8's 200 char-LM
    clients; returns (workload, clients, specs, config, round-0
    groups)."""
    from repro_torch.fed.fleet import get_workload

    wl = get_workload("xlstm")
    return (wl, clients) + fleet_setup(wl, clients)


def phase_xlstm(wl, clients, specs, cfg, groups):
    import torch

    from repro_torch.fed.fleet import run_fleet

    log_groups(groups)
    kept, launches, _ = fleet_main_run(wl, clients, specs, cfg,
                                       FLEET_KERNELS + ("rmsnorm",))

    def one_round():
        return run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)

    _, busy, by_name = bare_and_profiled(one_round, top=10)
    log_kernel_time(by_name, busy, "RMSNorm", "rmsnorm")
    log_kernel_time(by_name, busy, "pairwise", "pairwise_l2_kernel")
    log_kernel_time(by_name, busy, "distance-free (5-6)", "from_feats")
    log_kernel_time(by_name, busy, "BUILD over D (2)", "build_cost_walk")
    log_kernel_time(by_name, busy, "Δ-sweep over D (3)", "delta_sweep_")
    step_host_breakdown(wl, cfg, groups, torch.device("cuda"),
                        kernel="rmsnorm")
    return kept, launches


def phase_xlstm_ab(wl, clients, specs, cfg, kept):
    """(a) plain selection; (b) the plain RMSNorm on the card; (c) one
    loop round against one batched round on every ``XLSTM_LOOP_EVERY``-th
    client; (d) the scenario registry's fleet and sync runtimes."""
    import dataclasses

    import torch

    from repro_torch.fed.fleet import run_fleet, run_scenario
    from repro_torch.fed.fleet.workloads import CharXLSTM
    from repro_torch.fed.simulator import ClientSpec
    from repro_torch.kernels import ops

    log(f"  (a) use_kernel=False selection, {XLSTM_AB_ROUNDS} round(s)")
    plaunches = plain_selection_ab(wl, clients, specs, cfg, kept,
                                   XLSTM_AB_ROUNDS)
    check(plaunches["rmsnorm"] > 0,
          "the plain-selection run did not launch the RMSNorm kernel")

    m = wl.model
    plain = dataclasses.replace(wl, model=CharXLSTM(
        vocab=m.vocab, d_model=m.cfg.d_model, n_heads=m.cfg.n_heads,
        use_kernel=False))
    _, bkept, _, blaunches, bwall = run_fleet_recorded(
        plain, clients, specs, cfg, XLSTM_AB_ROUNDS, "batched")
    log(f"  (b) CharXLSTM(use_kernel=False), {XLSTM_AB_ROUNDS} round(s): "
        f"wall {bwall:.2f} s, launches {blaunches}")
    check(blaunches["rmsnorm"] == 0,
          f"the plain RMSNorm model launched the kernel: {blaunches}")
    check(all(blaunches[k] > 0 for k in FLEET_KERNELS),
          f"a selection kernel never launched: {blaunches}")
    check_same_rounds(kept, bkept, XLSTM_AB_ROUNDS,
                      "RMSNorm kernel and plain")

    sub = clients[::XLSTM_LOOP_EVERY]
    sub_specs = [ClientSpec(i, s.m, s.c)
                 for i, s in enumerate(specs[::XLSTM_LOOP_EVERY])]
    cfg_c = dataclasses.replace(cfg, epochs=XLSTM_LOOP_EPOCHS)
    _, skept, _, _, swall = run_fleet_recorded(wl, sub, sub_specs, cfg_c, 1,
                                               "batched")
    log(f"  (c) every {XLSTM_LOOP_EVERY}th client ({len(sub)}), "
        f"E={XLSTM_LOOP_EPOCHS}: one batched round, wall {swall:.2f} s, "
        f"{len(skept[0][0])} coresets of sizes "
        f"{sorted({len(v) for v in skept[0][0].values()})}")
    loop_round_ab(wl, sub, sub_specs, cfg_c, skept, PARAMS_ATOL_XLSTM)
    # why not phase 10's E = 5: there a 1-ulp change of the initial
    # parameters moves a round's result far beyond 1e-5 (no check: a
    # measurement of the model's sensitivity)
    p0 = wl.init(torch.Generator().manual_seed(cfg.seed))
    gen = torch.Generator(device=p0["embed"].device).manual_seed(1)
    p1 = {k: v * (1 + 2.0 ** -23 * torch.randn(v.shape, generator=gen,
                                                device=v.device))
          for k, v in p0.items()}
    ends = [run_fleet(wl, sub, sub_specs, cfg, 1, straggler_pct=30.0,
                      init_params=p)["params"] for p in (p0, p1)]
    log(f"  (c) sensitivity at E={cfg.epochs}: initial params moved by "
        f"{max(float((p0[k] - p1[k]).abs().max()) for k in p0):.3e} end "
        f"one batched round of the same clients "
        f"{max(float((ends[0][k] - ends[1][k]).abs().max()) for k in p0):.3e}"
        f" apart (at E={XLSTM_LOOP_EPOCHS}: see the loop A/B above)")

    for scenario, runtime in (("device_classes", "fleet"),
                              ("uniform", "sync")):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_scenario(scenario, runtime, workload="xlstm",
                           rounds=XLSTM_SCENARIO_ROUNDS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        hist = out["history"]
        log(f"  (d) run_scenario({scenario!r}, {runtime!r}, "
            f"workload='xlstm', rounds={XLSTM_SCENARIO_ROUNDS}): 24 "
            f"clients, wall {wall:.2f} s, coresets "
            f"{[h.n_coreset for h in hist]}, train_loss "
            f"{hist[-1].train_loss:.4f}, launches {launches}")
        check(launches["rmsnorm"] > 0,
              f"{scenario}/{runtime}: the RMSNorm kernel never launched")
        check(sum(h.n_coreset for h in hist) > 0,
              f"{scenario}/{runtime}: no coreset was built")
        check_params(out)


# ---------------------------------------------------------------------------
# phases 16-18: the dense LM path (yi-9b)
# ---------------------------------------------------------------------------

def record_decode_logits(model):
    """Keep the logits of each of ``model``'s decode steps from now on
    (a wrapper on the instance); returns the list they are kept in."""
    kept = []
    inner = model.decode_step

    def step(*args, **kwargs):
        logits, state = inner(*args, **kwargs)
        kept.append(logits)
        return logits, state

    model.decode_step = step
    return kept


def decode_steps(model, params, tokens, n):
    """``n`` decode steps of ``tokens`` (B, >= n) from an empty cache."""
    import torch

    state = model.init_decode_state(params, tokens.shape[0], n,
                                    dtype=torch.float32)
    with torch.no_grad():
        for t in range(n):
            model.decode_step(params, state, tokens[:, t:t + 1], t)


def check_lm_memory(dev, need_gib, what):
    """Fail with a clear message unless ``need_gib`` of the card's memory
    are free for ``what``."""
    import torch

    free, total = torch.cuda.mem_get_info(dev)
    log(f"  card memory: {free / 2**30:.1f} GiB free of "
        f"{total / 2**30:.1f} GiB")
    check(free >= need_gib * 2**30,
          f"only {free / 2**30:.1f} GiB of the card's memory are free; "
          f"{what} need {need_gib:.0f} GiB")


def lm_norm_launches(cfg, decode=False) -> int:
    """Kernel-8 launches of one forward pass (or, with ``decode``, one
    decode step): two norms a layer (a Mamba2 layer's input norm and
    gated norm, an attention layer's ln1 and ln2), two more each time the
    hybrid's shared block runs, an audio decoder layer's ln_x, one an
    mLSTM block and two an sLSTM block, and ln_f.  The audio encoder's
    (two a layer and enc_ln) run in the forward only."""
    if cfg.family == "xlstm":
        return len(cfg.xlstm_pattern) + cfg.xlstm_pattern.count("s") + 1
    if cfg.family == "audio":
        return 3 * cfg.n_layers + 1 + (0 if decode
                                       else 2 * cfg.enc_layers + 1)
    n = 2 * cfg.n_layers + 1
    if cfg.family == "hybrid" and cfg.attn_every:
        n += 2 * (cfg.n_layers // cfg.attn_every)
    return n


def lm_attention_launches(cfg) -> int:
    """Kernel-7 launches of one forward pass: one a self-attention layer,
    the audio encoder's and decoder's alike (cross-attention takes the
    chunked path); the xLSTM has none."""
    if cfg.family in ("ssm", "hybrid"):
        return (cfg.n_layers // cfg.attn_every
                if cfg.family == "hybrid" and cfg.attn_every else 0)
    if cfg.family == "xlstm":
        return 0
    return cfg.n_layers + (cfg.enc_layers if cfg.family == "audio" else 0)


def lm_decode_state_launches(cfg):
    """(kernel-7, kernel-8) launches of ``init_decode_state``: the audio
    model's encoder runs there once; no other family launches."""
    if cfg.family == "audio":
        return cfg.enc_layers, 2 * cfg.enc_layers + 1
    return 0, 0


def lm_prefill_flops(cfg, s: int, b: int = 1, s_enc: int = 0,
                     prefix: int = 0) -> float:
    """Operations of one forward pass over ``b`` sequences of ``s`` tokens
    (and an audio model's ``s_enc`` encoder frames, a VLM's ``prefix``
    patches): 2 a weight and token of every matrix product (an MoE
    layer's experts over their E·cap buffer rows, as the dispatch
    computes them), 4·hd a visible (q, k) pair and q head, the causal
    conv's multiply-adds, the SSD scan's einsums a chunk, the xLSTM
    cells' products and updates a step, and the unembedding of the text
    positions."""
    from repro_torch.models.moe import _capacity

    d = cfg.d_model
    mats = 3 if cfg.act == "silu" else 2
    hq, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def attention_layer(n, causal=True, mats=mats):
        ops = 2.0 * n * d * hd * (2 * hq + 2 * hk)
        ops += 4.0 * hd * (n * (n + 1) / 2 if causal else n * n) * hq
        ffn = 2.0 * n * mats * d * cfg.d_ff
        if cfg.n_experts:
            e = cfg.n_experts
            cap = _capacity(n, e, cfg.moe_capacity_factor)
            ops += 2.0 * n * d * e + 2.0 * e * cap * mats * d * cfg.d_ff
            ffn = ffn if cfg.use_shared_expert else 0.0
        return ops + ffn

    total = 2.0 * s * d * cfg.vocab_size
    if cfg.family == "audio":
        cross = (2.0 * s * d * hq * hd * 2 + 2.0 * s_enc * d * hk * hd * 2
                 + 4.0 * hd * s * s_enc * hq)
        total += cfg.enc_layers * attention_layer(s_enc, False, 2)
        total += cfg.n_layers * (attention_layer(s) + cross)
    elif cfg.family == "xlstm":
        h, hdx = cfg.n_heads, d // cfg.n_heads
        # mLSTM: q, k, v, o-gate and out (d x d), the i and f gates; a
        # step and head the (hd+1) x hd update i·[v kᵀ; kᵀ], the decay
        # and add, C q and n·q
        m_blk = (2.0 * s * d * (5 * d + 2 * h)
                 + s * h * (4.0 * (hdx + 1) * hdx + 2.0 * hdx * hdx
                            + 2.0 * hdx))
        # sLSTM: the four gates' input projection and out (d x d); a step
        # the block-diagonal R h of the four gates and the cell's ~20
        # operations an element
        s_blk = 2.0 * s * d * 5 * d + s * (8.0 * h * hdx * hdx + 20.0 * d)
        total += sum(m_blk if ch == "m" else s_blk
                     for ch in cfg.xlstm_pattern)
    elif cfg.family not in ("ssm", "hybrid"):
        total += cfg.n_layers * attention_layer(prefix + s)
    else:
        di, n, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        shd, l = cfg.ssm_headdim, cfg.ssm_chunk
        nc = -(-s // l)
        mamba = (2.0 * s * d * (2 * di + 2 * n + nh) + 2.0 * s * di * d
                 + 2.0 * s * cfg.ssm_conv * (di + 2 * n)
                 + nc * (2.0 * l * l * n + 2.0 * l * l * nh * shd
                         + 4.0 * l * nh * shd * n))
        total += cfg.n_layers * mamba
        calls = lm_attention_launches(cfg)
        total += calls * (attention_layer(s) + 2.0 * s * 2 * d * d)
    return b * total


def describe_lm(cfg) -> str:
    text = (f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"vocab {cfg.vocab_size}")
    if cfg.family in ("ssm", "hybrid"):
        text += (f", Mamba2 d_inner {cfg.d_inner}, {cfg.ssm_heads} heads "
                 f"of {cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
                 f"{cfg.ssm_chunk}")
        if cfg.family == "hybrid" and cfg.attn_every:
            text += f", a shared attention block every {cfg.attn_every}"
    if cfg.family == "xlstm":
        text += (f", blocks {cfg.xlstm_pattern} (m: mLSTM, s: sLSTM), "
                 f"{cfg.n_heads} heads of {cfg.d_model // cfg.n_heads}")
    elif cfg.family != "ssm":
        text += (f", {cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
                 f"{cfg.d_head}, d_ff {cfg.d_ff}")
    if cfg.family == "audio":
        text += (f", an encoder of {cfg.enc_layers} layers, cross-attention "
                 f"in each decoder layer")
    if cfg.family == "vlm":
        text += f", up to {cfg.n_patches} patches before the tokens"
    if cfg.n_experts:
        text += (f", {cfg.n_experts} experts top-1"
                 + (" + a shared expert" if cfg.use_shared_expert else ""))
    return text


def aten_calls(fn) -> int:
    """The ATen calls ``fn`` dispatches (views included), counted by a
    dispatch mode, without the profiler."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def draw_lm(dev, cfg):
    """``Model(cfg)`` and its fp32 params drawn on the card from seed 0."""
    import torch

    from repro_torch.models.model import Model

    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    log(f"  {describe_lm(cfg)}: {n:,} fp32 parameters "
        f"({4 * n / 2**30:.2f} GiB) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return model, params


@contextlib.contextmanager
def recording(owner, name, keep=None):
    """Record (args, result) of each call of ``owner.name`` (the first
    ``keep`` calls' in full, every call's result)."""
    calls = []
    real = getattr(owner, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args if keep is None or len(calls) < keep else None,
                      out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        setattr(owner, name, real)


def moe_routes(calls, n_layers=0, steps=0):
    """Each MoE layer's expert choices from ``recording(moe,
    "dispatch")``'s calls: a forward's one call a layer, or the first
    ``steps`` decode steps' (one call a layer a step, (B,) each), laid
    out in the forward's (b, s) token order."""
    import torch

    experts = [args[0] for args, _ in calls]
    if not steps:
        return experts
    return [torch.stack(experts[i::n_layers][:steps], dim=1).reshape(-1)
            for i in range(n_layers)]


def routing_flips(a, b) -> int:
    """The expert choices in which two runs' routes differ."""
    return sum(int((x != y).sum()) for x, y in zip(a, b))


@contextlib.contextmanager
def pinned_routing(routes):
    """``moe.dispatch`` with the i-th call's expert choices replaced by
    ``routes[i]``: another run's routing, so that an A/B compares the
    rest of the arithmetic.  A top-1 router flips at its near-ties under
    last-bit differences upstream (another attention's sums, another
    batch's products), and a flip moves a token to another expert, or
    past its expert's capacity, which no tolerance covers; the gate
    stays the run's own maximum, within the near-tie of the pinned
    expert's probability."""
    from repro_torch.models import moe

    real = moe.dispatch
    calls = iter(routes)
    moe.dispatch = lambda expert, e, cap: real(next(calls), e, cap)
    try:
        yield
    finally:
        moe.dispatch = real


def lm_serve(dev, model, params, fwd_model=None, fwd_extra=None):
    """``generate`` (``LM_SERVE``) on the kernels and on the plain twin:
    kernel 8 launched ``lm_norm_launches`` times a decode step and kernel
    7 never (``init_decode_state``'s own launches aside: the audio
    encoder's), finite logits, tokens and logits of the twin
    bit-identical, a decode step bare and busy against its bound (the
    weights it reads and the recurrent state it reads and writes or the
    encoder K/V it reads, over the memory rate) and its ATen calls, and
    the first token the argmax of ``fwd_model``'s forward (``model``'s
    by default, with ``fwd_extra``'s inputs: the audio model's zero
    encoder, the VLM's no patches, as their decode sees them) unless a
    near-tie (``LM_TIE``) explains it.  Returns the launch counts of the
    served run."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import generate, tput_str
    from repro_torch.models.model import Model

    cfg = model.cfg
    twin = Model(cfg, use_kernel=False)
    n = sum(v.numel() for v in params.values())
    b, p_len, gen = (LM_SERVE[k] for k in ("batch", "prompt_len", "gen"))
    prompts = torch.randint(
        0, cfg.vocab_size, (b, p_len), dtype=torch.int32, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    decode_steps(model, params, prompts, 2)          # first calls' set-up
    kept = record_decode_logits(model)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, params, prompts, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    steps = p_len + gen
    # the weights each step must read (all but an untied embedding table,
    # of which it reads B rows, and an audio model's encoder) and the
    # recurrent state it reads and writes (Mamba, xLSTM) or the encoder
    # K/V it reads
    emb = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    enc = sum(v.numel() for k, v in params.items()
              if k.startswith(("enc_layers.", "enc_ln.")))
    w_bytes = 4 * (n - emb - enc + b * cfg.d_model)
    st = model.init_decode_state(params, b, steps, dtype=torch.float32)
    s_bytes = 4 * (2 * sum(t.numel() for t in st.get("mamba", ()))
                   + 2 * sum(t.numel() for bs in st.get("blocks", ())
                             for t in bs)
                   + sum(st[k].numel() for k in ("enc_k", "enc_v")
                         if k in st))
    what = ("Mamba state read and written" if "mamba" in st else
            "xLSTM state read and written" if "blocks" in st else
            "encoder K/V read" if "enc_k" in st else "")
    del st
    log(f"  generate, batch {b}, prompt {p_len}, {gen} greedy tokens: wall "
        f"{wall:.3f} s, {tput_str(b * gen / wall)} (batch·gen / wall, "
        f"prefill included), {1e3 * wall / steps:.2f} ms a decode step "
        f"(bound: its {w_bytes / 2**30:.2f} GiB of weights"
        + (f" and {s_bytes / 2**30:.4f} GiB of {what}" if s_bytes else "")
        + f" at 3.35 TB/s, {1e3 * (w_bytes + s_bytes) / PEAK_BYTES_PER_S:.2f}"
        f" ms); launches {launches}")
    per_step = lm_norm_launches(cfg, decode=True)
    st_attn, st_norm = lm_decode_state_launches(cfg)
    check(launches["rmsnorm"] == per_step * steps + st_norm,
          f"kernel 8 launched {launches['rmsnorm']} times in {steps} decode "
          f"steps, not {per_step} a step and {st_norm} in the decode "
          "state's set-up")
    check(launches["flash_attention"] == st_attn,
          f"kernel 7 launched {launches['flash_attention']} times, not "
          f"{st_attn} (the decode steps launch none)")
    check(tuple(out.shape) == (b, steps) and torch.equal(out[:, :p_len],
                                                         prompts),
          f"generate returned {tuple(out.shape)} tokens")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "a generated token is outside the vocabulary")
    check(len(kept) == steps and all(bool(torch.isfinite(x).all())
                                      for x in kept),
          "a decode step's logits are not finite")
    del model.decode_step
    # one decode step's idle share: 8 steps bare, then under the profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode_steps(model, params, out, 8)
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / 8
    pwall, busy, by_name = device_busy_share(
        lambda: decode_steps(model, params, out, 8))
    if busy is None:
        log("  a decode step's device busy time: not measured")
    else:
        norm = sum(v for k, v in by_name.items() if "rmsnorm" in k) / 8
        log(f"  a decode step: bare {1e3 * bare:.2f} ms, device busy "
            f"{1e3 * busy / 8:.2f} ms (idle {100 * (1 - busy / 8 / bare):.1f}"
            f"% of the bare step), kernel 8 {1e3 * norm:.4f} ms of it")
    st = model.init_decode_state(params, b, 2, dtype=torch.float32)
    with torch.no_grad():
        n_aten = aten_calls(lambda: model.decode_step(params, st,
                                                      out[:, :1], 0))
    del st
    log(f"  a decode step dispatches {n_aten} ATen calls (views included)")

    from repro_torch.models import moe

    tkept = record_decode_logits(twin)
    with recording(moe, "dispatch") as routed:
        t0 = time.perf_counter()
        tout = generate(twin, params, prompts, gen)
        torch.cuda.synchronize()
    log(f"  plain twin (the plain RMSNorm): wall "
        f"{time.perf_counter() - t0:.3f} s")
    check(torch.equal(tout, out), "the plain twin generated other tokens")
    check(len(tkept) == len(kept) and all(torch.equal(x, y) for x, y in
                                          zip(kept, tkept)),
          "the plain twin's decode logits are not bit-identical")
    fwd_model = fwd_model or model
    pin = contextlib.nullcontext()
    with torch.no_grad():
        if cfg.n_experts:
            # the forward routed as the prompt's decode steps were
            routes = moe_routes(routed, cfg.n_layers, p_len)
            with recording(moe, "dispatch") as own:
                fwd_model.forward(params, {"tokens": prompts})
            log(f"  the forward over the prompts, routed on its own: "
                f"{routing_flips(moe_routes(own, cfg.n_layers), routes)} "
                f"of {b * p_len * cfg.n_layers} expert choices differ from "
                f"the decode steps'; the check below pins the decode "
                f"steps' routing")
            pin = pinned_routing(routes)
        del routed
        with pin:
            logits, _, _ = fwd_model.forward(
                params, {"tokens": prompts, **(fwd_extra or {})})
    last = logits[:, -1]
    top2 = torch.topk(last, 2, dim=-1).values
    first = out[:, p_len].long()
    chosen = last.gather(1, first[:, None])[:, 0]
    gap = float((top2[:, 0] - chosen).max())
    log(f"  first token {first.tolist()}, forward's argmax "
        f"{last.argmax(-1).tolist()}; chosen logit within {gap:.3e} of the "
        f"max, top-2 gaps {(top2[:, 0] - top2[:, 1]).tolist()}; the last "
        f"prompt step's decode logits against the forward's: max abs "
        f"{float((kept[p_len - 1][:, 0] - last).abs().max()):.3e}")
    for r in range(b):
        if int(first[r]) != int(last[r].argmax()):
            check(float(top2[r, 0] - top2[r, 1]) <= LM_TIE
                  and float(top2[r, 0] - chosen[r]) <= LM_TIE,
                  f"row {r}: the first generated token is not the "
                  f"forward's argmax and no near-tie ({LM_TIE:g}) explains "
                  f"it")
    return launches


def phase_lm_serve(dev):
    """Phase 16; returns (model, params, launch counts of the served
    run)."""
    from repro_torch.configs import get_config

    check_lm_memory(dev, LM_MIN_FREE_GIB,
                    "phases 16-17 (yi-9b's fp32 weights are 32.9 GiB)")
    model, params = draw_lm(dev, get_config(LM_ARCH))
    return model, params, lm_serve(dev, model, params)


def depth_cut(cfg, params, depth):
    """(cfg, params) of a model's first ``depth`` layers: the stacked
    leaves' first entries (views) of the dense, MoE and VLM families, an
    xLSTM's first blocks."""
    if cfg.family == "xlstm":
        keep = tuple(f"blocks.{i}." for i in range(depth))
        return (cfg.with_(n_layers=depth,
                          xlstm_pattern=cfg.xlstm_pattern[:depth]),
                {k: v for k, v in params.items()
                 if not k.startswith("blocks.") or k.startswith(keep)})
    check(cfg.family in ("dense", "moe", "vlm"),
          f"no depth cut for the {cfg.family} family")
    return cfg.with_(n_layers=depth), {
        k: v[:depth] if k.startswith("layers.") else v
        for k, v in params.items()}


def prefill_batch(dev, cfg):
    """``lm_prefill``'s default batch: one ``LM_PREFILL_S``-token sequence
    drawn from seed 2."""
    import torch

    return {"tokens": torch.randint(
        0, cfg.vocab_size, (1, LM_PREFILL_S), device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))}


def lm_prefill(dev, model, params, record=(), batch=None, twin_depth=None,
               warm=True):
    """One ``Model.forward`` through the kernels over ``batch`` (by
    default one ``LM_PREFILL_S``-token sequence), after one untimed call
    (its allocations and library set-up; not with ``warm=False``, for a
    host-bound model whose set-up is small beside its wall): kernel 7
    and 8 launched ``lm_attention_launches`` / ``lm_norm_launches``
    times, finite logits, the card's busy time and kernel 7's share of
    it, the plain twin bit-identical (logits and aux; with
    ``twin_depth``, both at that depth, ``depth_cut``, since the plain
    attention of a deep model takes a minute), chunked attention within
    1e-4·max|logits| (an MoE model's routed as the kernel run was,
    ``pinned_routing``; its own routing's flips are counted; a model
    without attention has no such A/B).  ``record`` names (owner,
    attribute, keep) to record (``recording``) during the plain twin's
    run.  Returns (launch counts, aux, the plain twin's MoE dispatches,
    the recorded calls, the logits)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    cfg = model.cfg
    twin = Model(cfg, use_kernel=False)
    if batch is None:
        batch = prefill_batch(dev, cfg)
    toks = batch["tokens"]
    b, s = toks.shape
    s_enc = (batch["encoder_embeddings"].shape[1]
             if "encoder_embeddings" in batch else 0)
    prefix = (batch["patch_embeddings"].shape[1]
              if "patch_embeddings" in batch else 0)
    what = (f"{b} x {s} tokens" + (f" and {s_enc} encoder frames"
                                   if s_enc else "")
            + (f" after {prefix} patches" if prefix else ""))
    with torch.no_grad():
        if warm:
            t0 = time.perf_counter()
            model.forward(params, batch)
            torch.cuda.synchronize()
            log(f"  first forward (allocations, library set-up): wall "
                f"{time.perf_counter() - t0:.3f} s")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, aux, hidden = model.forward(params, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        ops_n = lm_prefill_flops(cfg, s, b, s_enc, prefix)
        log(f"  forward, {what}, impl=None -> "
            f"{model.resolve_impl(None, toks.device)!r}: wall {wall:.3f} s, "
            f"{ops_n / wall / 1e12:.1f} TFLOP/s of {ops_n / 1e12:.2f} TFLOP "
            f"(bound {1e3 * ops_n / PEAK_FP32_FLOPS:.0f} ms at the fp32 "
            f"peak; TF32 off); launches {launches}")
        n_attn, n_norm = lm_attention_launches(cfg), lm_norm_launches(cfg)
        check(launches["flash_attention"] == n_attn,
              f"kernel 7 launched {launches['flash_attention']} times, not "
              f"{n_attn}")
        check(launches["rmsnorm"] == n_norm,
              f"kernel 8 launched {launches['rmsnorm']} times, not {n_norm}")
        check(tuple(logits.shape) == (b, s, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"prefill logits {tuple(logits.shape)} not finite")
        pwall, busy, by_name = device_busy_share(
            lambda: model.forward(params, batch))
        if busy is None:
            log("  device busy time: not measured")
        else:
            fa = sum(v for k, v in by_name.items() if "flash_attention" in k)
            norm = sum(v for k, v in by_name.items() if "rmsnorm" in k)
            log(f"  under torch.profiler (wall {pwall:.3f} s): busy "
                f"{busy:.3f} s, idle {100 * (1 - busy / wall):.1f}% of the "
                f"bare wall ({100 * (1 - busy / pwall):.1f}% of the "
                f"profiled one); kernel 7 {fa:.3f} s "
                f"({100 * fa / busy:.1f}% of the busy time, "
                f"{1e3 * fa / max(n_attn, 1):.3f} ms a call), kernel 8 "
                f"{1e3 * norm:.3f} ms")
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log("  busiest device activities: " + "; ".join(
                f"{k.split('(')[0][-50:]} {1e3 * v:.1f} ms" for k, v in top))
            check(fa > 0 or not n_attn,
                  "the profiled prefill ran no kernel 7")
        with contextlib.ExitStack() as stack:
            routed = stack.enter_context(recording(moe, "dispatch"))
            recorded = [stack.enter_context(recording(*r)) for r in record]
            want, waux, tparams, depth = logits, aux, params, ""
            if twin_depth and twin_depth < cfg.n_layers:
                check(not (record or cfg.n_experts),
                      "a depth-cut twin records nothing")
                ccfg, tparams = depth_cut(cfg, params, twin_depth)
                twin = Model(ccfg, use_kernel=False)
                want, waux, _ = Model(ccfg).forward(tparams, batch)
                depth = (f" at depth {twin_depth} of {cfg.n_layers}, "
                         f"against the kernels at that depth")
            t0 = time.perf_counter()
            plain, paux, _ = twin.forward(tparams, batch, impl="kernel")
            torch.cuda.synchronize()
        same = torch.equal(plain, want) and torch.equal(paux, waux)
        log(f"  plain twin (the kernels' plain versions){depth}: wall "
            f"{time.perf_counter() - t0:.3f} s; bit-identical {same}")
        check(same, "the plain twin's prefill logits are not bit-identical: "
              f"max abs {float((plain - want).abs().max()):.3e}")
        del plain, want
        if not n_attn:
            log("  no attention, so no chunked A/B")
            return launches, aux, routed, recorded, logits
        scale = float(logits.abs().max())
        pin = contextlib.nullcontext()
        if cfg.n_experts:
            with recording(moe, "dispatch") as own:
                chunked, _, _ = model.forward(params, batch, impl="chunked")
            log(f"  impl='chunked' routed on its own: "
                f"{routing_flips(moe_routes(own), moe_routes(routed))} of "
                f"{s * cfg.n_layers} expert choices differ from the kernel "
                f"run's; logits max abs "
                f"{float((chunked - logits).abs().max()):.3e} (a flipped "
                f"token moves to another expert, or past a capacity); the "
                f"check below pins the kernel run's routing")
            del own, chunked
            pin = pinned_routing(moe_routes(routed))
        t0 = time.perf_counter()
        with pin:
            chunked, _, _ = model.forward(params, batch, impl="chunked")
        torch.cuda.synchronize()
        err = float((chunked - logits).abs().max())
        log(f"  impl='chunked': wall {time.perf_counter() - t0:.3f} s; max "
            f"abs {err:.3e} against the kernel's, max|logits| {scale:.3f}")
        check(err <= 1e-4 * scale, f"chunked attention's prefill is "
              f"{err:.3e} from the kernel's (limit {1e-4 * scale:.3e})")
    return launches, aux, routed, recorded, logits


def phase_lm_prefill(dev, model, params):
    """Phase 17; returns the launch counts of the kernel forward."""
    return lm_prefill(dev, model, params)[0]


def phase_lm_train(dev):
    """Phase 18; returns the launch counts of (a) and (b) and (b)'s solves'
    (M, k)."""
    import shutil

    import torch

    from repro_torch.checkpoint import load_server_state
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train_centralized, train_fedcore_lm

    cfg = get_config(LM_ARCH).with_(n_layers=LM_TRAIN_DEPTH)
    ckpt = LANE_DIR / "lm_checkpoint"
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = train_centralized(cfg, ckpt_dir=str(ckpt), log_every=5, seed=0,
                            device=dev, **LM_TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tlaunches = dict(ops.LAUNCHES)
    steps = LM_TRAIN["steps"]
    losses = out["losses"]
    log(f"  (a) train_centralized at depth {LM_TRAIN_DEPTH}: {steps} steps "
        f"in {wall:.2f} s (checkpoint included); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches {tlaunches}")
    check(losses[-1] < losses[0], "training did not lower the loss")
    check(tlaunches["flash_attention"] == LM_TRAIN_DEPTH * steps
          and tlaunches["rmsnorm"] == (2 * LM_TRAIN_DEPTH + 1) * steps,
          f"kernels 7 / 8 launched {tlaunches['flash_attention']} / "
          f"{tlaunches['rmsnorm']} times in {steps} steps")
    t0 = time.perf_counter()
    loaded, step = load_server_state(str(ckpt), like=out["params"])
    nbytes = sum(f.stat().st_size for f in ckpt.iterdir())
    same = step == steps and all(torch.equal(loaded[k], v)
                                 for k, v in out["params"].items())
    log(f"  checkpoint {nbytes:,} bytes read back in "
        f"{time.perf_counter() - t0:.2f} s: step {step}, params "
        f"bit-identical {same}")
    check(same, "the checkpoint did not give the params back bit for bit")
    shutil.rmtree(ckpt)
    del out, loaded
    torch.cuda.empty_cache()

    with solver_shapes() as hist:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fout = train_fedcore_lm(cfg, device=dev, **LM_FEDCORE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        flaunches = dict(ops.LAUNCHES)
    hist_k = [(h["round"], h["coreset_silos"],
               round(float(h["round_time"] / h["tau"]), 4), h["loss"])
              for h in fout["history"]]
    n_core = sum(h["coreset_silos"] for h in fout["history"])
    sizes = [{silo: len(c) for silo, c in r.items()}
             for r in fout["coresets"]]
    log(f"  (b) train_fedcore_lm at depth {LM_TRAIN_DEPTH}: wall "
        f"{wall:.2f} s; (round, coreset silos, time / tau, loss) {hist_k}; "
        f"coreset sizes by silo {sizes} of m = "
        f"{LM_FEDCORE['steps_per_epoch'] * LM_FEDCORE['batch']}; "
        f"launches {flaunches}")
    log_solver_shapes(hist)
    check(n_core > 0, "no silo selected a coreset")
    check(all(h["round_time"] <= h["tau"] * 1.001 for h in fout["history"]),
          "a FedCore-for-LM round missed its deadline")
    check(all(flaunches[k] > 0 for k in SYNC_KERNELS + ("flash_attention",
                                                        "rmsnorm")),
          f"a kernel never launched on the LM FedCore path: {flaunches}")
    check(flaunches["pairwise_l2"] == n_core,
          f"kernel 1 launched {flaunches['pairwise_l2']} times for {n_core} "
          f"coresets")
    params = fout.pop("params")
    t0 = time.perf_counter()
    pout = train_fedcore_lm(cfg, device=dev, use_kernel=False, **LM_FEDCORE)
    torch.cuda.synchronize()
    log(f"  plain twin: wall {time.perf_counter() - t0:.2f} s")
    check(pout["coresets"] == fout["coresets"],
          "the plain twin selected other coresets")
    check([h["loss"] for h in pout["history"]]
          == [h["loss"] for h in fout["history"]],
          "the plain twin's losses differ")
    check(all(torch.equal(pout["params"][k], v) for k, v in params.items()),
          "the plain twin's params are not bit-identical")
    log("  plain twin: coresets equal, losses equal, params bit-identical")
    return tlaunches, flaunches, sorted(hist)


# ---------------------------------------------------------------------------
# phase 19: the sharded fleet
# ---------------------------------------------------------------------------

SHARDED_RANKS = 2
SHARDED_ROUNDS = 2
# a coreset one path picks where the other picks another, on the same
# features, is tied with it when their f64 k-medoids objectives are
# within SHARDED_TIE (phase 4's rule); params after a round that a tie
# parted are logged, not held.  (c)'s two selections differ in more
# than their float32 rounding (the fused one rebuilds distances from the
# features, the chain stores D and sweeps the legacy way), and SmallCNN's
# gradient features at (M, k) = (512, 64) hold near-equal local optima
# that they may part on, as the JAX package's two paths do (ROADMAP queue
# 3): such a lane's coresets must each be within SELECT_QUALITY of the
# f64 BUILD + SWAP's objective (``kmedoids_numpy``) on the features
SHARDED_TIE = 1e-5
SELECT_QUALITY = 1e-3
# params of a sharded round against the batched one's: (a) runs every
# group's lanes in one vmap, as batched does, so only the reduction's
# summation order differs (the reference's 1e-5); (b) vmaps each group's
# rank block, and the CNN's vmapped convolutions at another lane count
# move a lane's params (the lane-count A/B): the reference's CNN engine
# tolerance (PARAMS_ATOL_CNN) holds those
SHARDED_ATOL = 1e-5


def check_sharded_medoids(wl, clients, got, want, params0, what):
    """Medoids per client of a sharded round (``got``) against a batched
    round's from the same round-start params ``params0`` (``want``):
    equal, or tied in the f64 objective over the client's features at
    ``params0``.  Returns the number of tied clients."""
    import torch

    from repro_torch.core.kmedoids import medoid_objective_f64

    check(set(got) == set(want), f"{what}: other clients selected")
    n_tied = 0
    dev = next(iter(params0.values())).device
    for cid, med in want.items():
        if (got[cid] == med).all():
            continue
        with torch.no_grad():
            f = wl.grad_features(params0, {
                k: torch.as_tensor(v, device=dev)
                for k, v in clients[cid].items()}).double().cpu().numpy()
        fg, fw = medoid_objective_f64(f, got[cid]), medoid_objective_f64(
            f, med)
        rel = abs(fg - fw) / max(abs(fw), 1e-30)
        log(f"  {what}: client {cid} picks another coreset, f64 "
            f"objectives {fg:.10g} vs {fw:.10g} (rel {rel:.2e})")
        check(rel <= SHARDED_TIE, f"{what}: client {cid}'s coresets differ "
              f"beyond a tie")
        n_tied += 1
    return n_tied


def check_sharded_params(got, want, tied, what, atol):
    """Params of a sharded round against the batched round's: within
    ``atol`` unless a tie parted the rounds' coresets."""
    diff = max(float((got[k].to(want[k].device) - want[k]).abs().max())
               for k in want)
    log(f"  {what}: params max abs diff {diff:.3e} from the batched "
        f"round's" + (f" (after {tied} tied coresets: not held)"
                      if tied else f" (atol {atol:g})"))
    check(tied or diff <= atol, f"{what}: params differ by {diff:.3e}")


def sharded_round_walls(records):
    """(round walls, all-reduce seconds a round) from a run's spans."""
    spans = [r for r in records if r["kind"] == "span"]
    by_sid = {s["sid"]: s for s in spans}
    walls = [s["dur"] for s in spans if s["name"] == "round"]
    reduce_s = [0.0] * len(walls)
    for s in spans:
        if s["name"] != "allreduce":
            continue
        p = by_sid.get(s["parent"])
        while p is not None and p["name"] != "round":
            p = by_sid.get(p["parent"])
        if p is not None:
            reduce_s[p["attrs"]["round"]] += s["dur"]
    return walls, reduce_s


def phase_select_group(wl, clients, cfg, groups, params0, dev):
    """(c): ``select_group_coresets`` on the largest straggler group, fused
    (kernels 5-6) and the pre-fusion chain (plain PyTorch); returns the
    fused call's launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.kmedoids import (kmedoids_numpy,
                                           medoid_objective_f64)
    from repro_torch.fed.fleet import FleetEngine
    from repro_torch.kernels import ops

    g = max((g for g in groups if g.k > 0),
            key=lambda g: (g.valid.shape[1], g.k))
    log(f"  largest straggler group: M = {g.valid.shape[1]}, k = {g.k}, "
        f"C = {g.n_clients}")
    check(g.valid.shape[1] >= cfg.materialize_below,
          "the largest straggler group is below the distance-free cutover")
    eng = FleetEngine(wl, cfg, device=dev)
    out, walls = {}, {}
    for fused in (True, False):
        for _ in range(2):          # a warm call, then the timed one
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            n0 = eng.dispatch_count
            t0 = time.perf_counter()
            coreset, n = eng.select_group_coresets(params0, g, fused=fused)
            torch.cuda.synchronize()
            walls[fused] = time.perf_counter() - t0
        out[fused] = (coreset, n, eng.dispatch_count - n0, dict(ops.LAUNCHES))
    (fc, fn, fd, fl), (cc, cn, cd, cl) = out[True], out[False]
    log(f"  fused: {fn} dispatch, wall {walls[True] * 1e3:.2f} ms, launches "
        f"{fl}; chain: {cn} dispatches, wall {walls[False] * 1e3:.2f} ms, "
        f"launches {cl}")
    check((fn, cn) == (1, 3) and (fd, cd) == (1, 3),
          f"dispatch counts {(fn, cn)} / {(fd, cd)}, not (1, 3)")
    check(fl["build_cost_from_feats"] > 0 and fl["delta_sweep_from_feats"] > 0,
          f"the fused selection did not launch kernels 5-6: {fl}")
    check(not any(cl.values()), f"the chain launched a kernel: {cl}")
    fo, co = fc.objective.cpu().numpy(), cc.objective.cpu().numpy()
    with torch.no_grad():
        feats = eng._group_features(params0, {
            f: torch.as_tensor(v, device=dev) for f, v in g.data.items()},
            g.n_clients).double().cpu().numpy()
    n_tied = n_parted = 0
    for c in range(g.n_clients):
        if abs(fo[c] - co[c]) <= 1e-6 * abs(co[c]):
            continue
        m = int(g.m[c])
        x = feats[c, :m]
        ff = medoid_objective_f64(x, fc.indices[c].cpu().numpy())
        fch = medoid_objective_f64(x, cc.indices[c].cpu().numpy())
        rel = abs(ff - fch) / max(abs(fch), 1e-30)
        line = (f"  lane {c}: objectives {fo[c]:.7g} vs {co[c]:.7g}; f64 "
                f"{ff:.10g} vs {fch:.10g} (rel {rel:.2e})")
        if rel <= SHARDED_TIE:
            log(line + ": tied")
            n_tied += 1
            continue
        # distinct local optima: each as good as the f64 BUILD + SWAP's
        sq = (x * x).sum(1)
        D = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T),
                               0.0))
        np.fill_diagonal(D, 0.0)
        best = float(kmedoids_numpy(D, g.k, cfg.max_sweeps).objective)
        worst = (max(ff, fch) - best) / best
        log(line + f": distinct local optima, the f64 solve's {best:.10g}, "
            f"the worse path {worst:.2e} above it")
        check(worst <= SELECT_QUALITY, f"lane {c}: a coreset more than "
              f"{SELECT_QUALITY:g} above the f64 solve's objective")
        n_parted += 1
    same = sum(bool((fc.indices[c] == cc.indices[c]).all())
               for c in range(g.n_clients))
    log(f"  {g.n_clients} lanes: {same} equal coresets, objectives within "
        f"rel 1e-6 on {g.n_clients - n_tied - n_parted}, {n_tied} tied in "
        f"f64, {n_parted} distinct local optima")
    check(all(int(w.sum()) == int(m) for w, m in zip(
        np.asarray(fc.weights.cpu()), g.m)), "fused weights do not "
          "partition the clients' samples")
    return fl


def phase_cost_model():
    """(d): ``workload_cost_model`` on the card's machine: the CPU tests'
    counts for all five workloads, by FLOPs."""
    from repro_torch.fed import workload_cost_model

    want = {"mlp": 2400.0, "cnn": 1106240.0, "charlm": 679936.0,
            "xlstm": 749568.0, "translm": 1277952.0}
    t0 = time.perf_counter()
    cms = {n: workload_cost_model(n) for n in want}
    log(f"  workload_cost_model ({time.perf_counter() - t0:.2f} s): " +
        ", ".join(f"{n} {cm.flops_per_sample:.0f} FLOPs a sample "
                  f"(x{cm.cost_per_sample:.2f}, {cm.source})"
                  for n, cm in cms.items()))
    check(all(cm.source == "flops" and cm.flops_per_sample == want[n]
              for n, cm in cms.items()),
          "the cost model's counts differ from the CPU's")


def phase_one_nccl_rank(wl, clients, specs, cfg, params0, kept, dev):
    """(a): one round of ``ShardedFleetEngine`` on a one-rank NCCL group
    against the batched run's first round; returns its launch counts."""
    import torch
    import torch.distributed as dist

    from repro_torch.fed.fleet import (ShardedFleetEngine, client_mesh,
                                       nominal_budgets, run_fleet_round)
    from repro_torch.fed.simulator import straggler_deadline
    from repro_torch.kernels import ops

    store = LANE_DIR / "nccl_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(store), 1))
    try:
        eng = ShardedFleetEngine(wl, cfg, mesh=client_mesh(devices=[dev]),
                                 device=dev)
        budgets = nominal_budgets(
            specs, straggler_deadline(specs, cfg.epochs, 30.0), cfg.epochs)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, stats = run_fleet_round(eng, params0, clients,
                                        list(range(len(clients))), budgets,
                                        mode="sharded")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
    finally:
        dist.destroy_process_group()
    log(f"  one NCCL rank, one round: wall {wall:.3f} s, "
        f"{eng.dispatch_count} dispatches, launches {launches}")
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched on the one-rank sharded round: "
          f"{launches}")
    meds, want = stats.medoids, kept[0]
    tied = check_sharded_medoids(wl, clients, meds, want[0], params0,
                                 "one NCCL rank")
    check_sharded_params(params, want[1], tied, "one NCCL rank",
                         SHARDED_ATOL)
    log(f"  {len(meds)} coresets: {len(meds) - tied} equal to the batched "
        f"round's, {tied} tied")
    return launches


def lane_count_ab(wl, cfg, groups, params0, dev):
    """The batched group body on each group's lanes, all at once and in
    the blocks the ``SHARDED_RANKS`` ranks of (b) run (the padded group's
    contiguous lanes): each lane's params after its round, compared and
    logged.  The selection is per lane; the vmapped SGD's convolutions
    may take other algorithms at another lane count, which moves a
    lane's params."""
    import numpy as np

    from repro_torch.fed.fleet import CohortGroup, FleetEngine

    eng = FleetEngine(wl, cfg, device=dev)
    parts = []
    for g in groups:
        full, _, meds = eng.run_group(params0, g)
        c = g.n_clients
        pad = (-c) % SHARDED_RANKS
        per = (c + pad) // SHARDED_RANKS
        diff, same = 0.0, True
        for r in range(SHARDED_RANKS):
            lanes = np.minimum(np.arange(r * per, (r + 1) * per), c - 1)
            sub = CohortGroup(
                cids=g.cids[lanes],
                data={f: v[lanes] for f, v in g.data.items()},
                valid=g.valid[lanes], m=g.m[lanes], k=g.k,
                perms=g.perms[lanes])
            p, _, m = eng.run_group(params0, sub)
            diff = max([diff] + [float((full[k][lanes] - p[k]).abs().max())
                                 for k in full])
            same = same and (meds is None or bool((meds[lanes] == m).all()))
        check(same, f"group {g.valid.shape[1], g.k, c}: a lane's medoids "
              "depend on the lane count")
        parts.append(f"({g.valid.shape[1]}, {g.k}, {c}) {diff:.2e}")
    log(f"  lane-count A/B, each group's lanes vmapped all at once and in "
        f"{SHARDED_RANKS} rank blocks, (M, k, C) params max abs diff: "
        + ", ".join(parts) + "; medoids equal")


def run_sharded_ranks():
    """(b): start the ``SHARDED_RANKS`` gloo ranks on the card, wait for
    them and return their results."""
    import torch

    (LANE_DIR / "gloo_init").unlink(missing_ok=True)
    names = [f"sharded_rank{r}" for r in range(SHARDED_RANKS)]
    failed = run_children({n: ["--rank", str(r), str(SHARDED_RANKS)]
                           for r, n in enumerate(names)})
    check(not failed, f"sharded rank(s) {', '.join(failed)} failed or were "
          "stopped")
    return [torch.load(LANE_DIR / f"{n}.pt", weights_only=False)
            for n in names]


def sharded_rank_main(rank: int, world: int, parent: int) -> int:
    """One rank of (b), started by the sharded lane: dies with it, joins
    the gloo group through ``build/chip_smoke/gloo_init`` and runs
    ``sharded_rank_run`` on the card."""
    import ctypes
    import datetime

    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        return 1
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    setup_torch()
    dist.init_process_group(
        "gloo", init_method=f"file://{LANE_DIR / 'gloo_init'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        sharded_rank_run(rank, torch.device("cuda", 0))
    finally:
        dist.destroy_process_group()
    return 0


def sharded_rank_run(rank: int, dev):
    """(b) on one rank: ``run_fleet(engine="sharded")`` for
    ``SHARDED_ROUNDS`` rounds and one flush of
    ``run_async_fleet(engine="sharded")`` on phase 6's fleet, each with
    the launch counts set to 0 just before and read just after; writes
    the results to ``build/chip_smoke/sharded_rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    from repro_torch.fed.fleet import AsyncFleetConfig

    wl = cnn_fleet_workload()
    clients = wl.make_clients()
    specs, cfg, _ = fleet_setup(wl, clients)
    out, kept, records, launches, wall = run_fleet_recorded(
        wl, clients, specs, cfg, SHARDED_ROUNDS, "sharded", device=dev)
    log(f"rank {rank}: {SHARDED_ROUNDS} rounds, wall {wall:.2f} s, "
        f"engine_mode {out['engine_mode']}, launches {launches}")
    one = AsyncFleetConfig(**dict(ASYNC_FLEET, max_updates=1))
    aout, arec, _, alaunches, awall = run_async_fleet_recorded(
        wl, clients, specs, one, engine="sharded", aggregator="fedbuff",
        device=dev)
    log(f"rank {rank}: one async flush, wall {awall:.2f} s, engine_mode "
        f"{aout['engine_mode']}, launches {alaunches}")
    dist.barrier()
    walls, reduce_s = sharded_round_walls(records)
    torch.save({
        "engine_mode": out["engine_mode"], "n_devices": out["n_devices"],
        "kept": [(m, {k: v.cpu() for k, v in p.items()}) for m, p in kept],
        "history": out["history"], "launches": launches, "wall": wall,
        "walls": walls, "allreduce_s": reduce_s, "n_records": len(records),
        "async": {"event_log": aout["event_log"],
                  "engine_mode": aout["engine_mode"],
                  "medoids": arec["medoids"],
                  "params": {k: v.cpu() for k, v in aout["params"].items()},
                  "launches": alaunches, "wall": awall}},
        LANE_DIR / f"sharded_rank{rank}.pt")


def phase_sharded(dev):
    """Phase 19 on ``dev``: (c) the selection A/B, (d) the cost model, the
    batched references, (a) one NCCL rank, (b) two gloo ranks on the card;
    returns the launch counts of each path."""
    import torch

    from repro_torch.fed.fleet import (AsyncFleetConfig, FleetEngine,
                                       nominal_budgets, run_fleet_round)
    from repro_torch.fed.simulator import straggler_deadline

    wl = cnn_fleet_workload()
    clients = wl.make_clients()
    specs, cfg, groups = fleet_setup(wl, clients)
    params0 = wl.init(torch.Generator().manual_seed(cfg.seed), dev)
    log_groups(groups)
    log("  (c) select_group_coresets, fused and the pre-fusion chain:")
    slaunches = phase_select_group(wl, clients, cfg, groups, params0, dev)
    log("  (d) the cost model:")
    phase_cost_model()

    out, kept, records, blaunches, bwall = run_fleet_recorded(
        wl, clients, specs, cfg, SHARDED_ROUNDS, "batched", device=dev)
    bwalls, _ = sharded_round_walls(records)
    log(f"  batched reference, {SHARDED_ROUNDS} rounds: wall {bwall:.2f} s, "
        f"round walls " + ", ".join(f"{w:.3f}" for w in bwalls))
    one = AsyncFleetConfig(**dict(ASYNC_FLEET, max_updates=1))
    aout, arec, _, _, awall = run_async_fleet_recorded(
        wl, clients, specs, one, aggregator="fedbuff", device=dev)
    log(f"  batched reference, one async flush: wall {awall:.2f} s")

    log("  (a) one NCCL rank:")
    nlaunches = phase_one_nccl_rank(wl, clients, specs, cfg, params0, kept,
                                    dev)

    lane_count_ab(wl, cfg, groups, params0, dev)

    log(f"  (b) {SHARDED_RANKS} gloo ranks sharing the card:")
    ranks = run_sharded_ranks()
    lead, other = ranks
    check(all(torch.equal(v, o[1][k]) for (_, p), o in zip(lead["kept"],
                                                          other["kept"])
              for k, v in p.items())
          and all(torch.equal(v, other["async"]["params"][k])
                  for k, v in lead["async"]["params"].items()),
          "the ranks' params are not bit-identical")
    # each sharded round against a batched round from its own round-start
    # params: round 0 the batched run's, later rounds one more batched
    # round (the engines' params part after a round, so their later
    # selections run on other features)
    budgets = nominal_budgets(
        specs, straggler_deadline(specs, cfg.epochs, 30.0), cfg.epochs)
    want_rounds = [kept[0]]
    for i in range(1, SHARDED_ROUNDS):
        start = {k: v.to(dev) for k, v in lead["kept"][i - 1][1].items()}
        p, st = run_fleet_round(FleetEngine(wl, cfg, device=dev), start,
                                clients, list(range(len(clients))), budgets,
                                round_seed=i)
        want_rounds.append((st.medoids, p))
    for r, res in enumerate(ranks):
        check((res["engine_mode"], res["n_devices"])
              == ("sharded", SHARDED_RANKS),
              f"rank {r} ran {res['engine_mode']} on {res['n_devices']}")
        check(all(res["launches"][k] > 0 for k in FLEET_KERNELS),
              f"rank {r} never launched a fleet kernel: {res['launches']}")
        check(all(res["async"]["launches"][k] > 0 for k in FLEET_KERNELS[:3]),
              f"rank {r}'s async flush never launched a selection kernel: "
              f"{res['async']['launches']}")
        for i, ((gm, gp), (wm, wp)) in enumerate(zip(res["kept"],
                                                     want_rounds)):
            start = params0 if i == 0 else {
                k: v.to(dev) for k, v in res["kept"][i - 1][1].items()}
            tied = check_sharded_medoids(wl, clients, gm, wm, start,
                                         f"rank {r} round {i}")
            check_sharded_params(gp, wp, tied, f"rank {r} round {i}",
                                 PARAMS_ATOL_CNN)
        check([h.client_times for h in res["history"]]
              == [h.client_times for h in out["history"]],
              f"rank {r}: the history's timing differs from batched")
        a = res["async"]
        check(a["engine_mode"] == "sharded"
              and a["event_log"] == aout["event_log"],
              f"rank {r}: the async flush's event log differs from batched")
        check_same_medoids(a["medoids"], arec["medoids"],
                           f"rank {r} async flush")
    check(lead["n_records"] > 0 and other["n_records"] == 0,
          "rank 0 alone must write the recorder's sinks")
    sync_lane = LANE_DIR / "sync_cnn.json"
    bare = (json.loads(sync_lane.read_text()).get("fleet_bare_round_s")
            if sync_lane.exists() else None)
    log(f"  ranks' params bit-identical after every round; async event "
        f"logs equal "
        f"({len(aout['event_log'])} events)")
    log(f"  round walls s: sharded (rank 0) " + ", ".join(
        f"{w:.3f} (all-reduce {s:.4f})" for w, s in
        zip(lead["walls"], lead["allreduce_s"])) + "; batched " + ", ".join(
        f"{w:.3f}" for w in bwalls) + (f"; phase 6's bare round {bare:.3f}"
                                       if bare else "")
        + f"; async flush: sharded {lead['async']['wall']:.2f} s, batched "
        f"{awall:.2f} s")

    both = {k: sum(r["launches"][k] for r in ranks) for k in blaunches}
    both_async = {k: sum(r["async"]["launches"][k] for r in ranks)
                  for k in blaunches}
    return {"fleet_sharded": both, "async_fleet_sharded": both_async,
            "fleet_sharded_nccl": nlaunches, "select_group": slaunches}


# ---------------------------------------------------------------------------
# phases 20-21: the MoE and hybrid LM families
# ---------------------------------------------------------------------------

def phase_lm_moe(dev):
    """Phase 20; returns the launch counts of the prefill and of the
    served run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    cfg = get_config(MOE_ARCH).with_(n_layers=MOE_DEPTH)
    check_lm_memory(dev, MOE_MIN_FREE_GIB,
                    f"phase 20 ({cfg.arch_id} at depth {MOE_DEPTH}: "
                    "40.5 GiB of fp32 weights, and the prefill)")
    model, params = draw_lm(dev, cfg)
    log(f"  (a) prefill of {LM_PREFILL_S} tokens")
    launches, aux, routed = lm_prefill(dev, model, params)[:3]
    e = cfg.n_experts
    cap = moe._capacity(LM_PREFILL_S, e, cfg.moe_capacity_factor)
    loads = [torch.bincount(args[0], minlength=e).tolist()
             for args, _ in routed]
    dropped = [int((~keep).sum()) for _, (_, _, keep) in routed]
    log(f"  aux {float(aux):.6f} (the {cfg.n_layers} layers' Switch losses "
        f"summed, each in [0, {e}]); capacity {cap} tokens an expert; "
        f"tokens dropped by layer {dropped} of {LM_PREFILL_S}; the largest "
        f"expert load by layer {[max(x) for x in loads]}")
    check(len(routed) == cfg.n_layers,
          f"{len(routed)} MoE dispatches in {cfg.n_layers} layers")
    check(all(sum(x) == LM_PREFILL_S for x in loads)
          and dropped == [sum(max(0, c - cap) for c in x) for x in loads],
          "the dispatch dropped other tokens than each expert's past "
          "its capacity")
    check(bool(torch.isfinite(aux)) and 0.0 <= float(aux)
          <= e * cfg.n_layers, f"aux {float(aux)} not finite or outside "
          f"[0, {e * cfg.n_layers}]")
    del routed
    log(f"  (b) serving; the first token against the forward at a capacity "
        f"of every token (a decode step at batch {LM_SERVE['batch']}, cap "
        f"{moe._capacity(LM_SERVE['batch'], e, cfg.moe_capacity_factor)}, "
        f"drops none; the forward over the prompts may)")
    slaunches = lm_serve(dev, model, params, fwd_model=Model(
        cfg.with_(moe_capacity_factor=float(e))))
    return launches, slaunches


def phase_lm_hybrid(dev):
    """Phase 21; returns the launch counts of the prefill and of the
    served run."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import mamba2

    cfg = get_config(HYBRID_ARCH)
    check_lm_memory(dev, HYBRID_MIN_FREE_GIB,
                    f"phase 21 ({cfg.arch_id}: 4.15 GiB of fp32 weights, "
                    "and the prefill)")
    model, params = draw_lm(dev, cfg)
    log(f"  (a) prefill of {LM_PREFILL_S} tokens")
    launches, aux, _, (ssd,), logits = lm_prefill(
        dev, model, params, record=[(mamba2, "ssd_chunked", 1)])
    check(float(aux) == 0.0, f"the hybrid's aux is {float(aux)}, not 0")
    (x, a, B, C, chunk), (y, h) = ssd[0]
    del ssd
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        ys, hs = mamba2.ssd_sequential(x, a, B, C)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    errs = [(float((g - w).abs().max()),
             bool(((g - w).abs() <= SSD_TOL + SSD_TOL * w.abs()).all()),
             float(w.abs().max())) for g, w in ((y, ys), (h, hs))]
    log(f"  ssd_chunked (chunk {chunk}) against ssd_sequential ({wall:.2f} "
        f"s) on layer 0's own inputs, x {tuple(x.shape)}, N = "
        f"{B.shape[-1]}: y max abs {errs[0][0]:.3e} (max|y| "
        f"{errs[0][2]:.3f}), final state max abs {errs[1][0]:.3e} "
        f"(max|h| {errs[1][2]:.3f})")
    check(all(ok for _, ok, _ in errs),
          f"ssd_chunked is not within rtol = atol = {SSD_TOL:g} of "
          "ssd_sequential")
    del x, a, B, C, y, h, ys, hs
    log("  (b) serving")
    return launches, lm_serve(dev, model, params), (model, params, logits)


def phase_host_mesh(dev, model, params, logits, launches):
    """Phase 26: zamba2's params placed on ``make_host_mesh()`` (a (1, 1)
    mesh over a world of one, NCCL) by ``param_specs`` ("tp") as DTensors
    (``distribute_tensor``), each shard bit-identical to its param; phase
    21's prefill run from the local shards, through kernels 7 and 8 as
    often as there, bit-identical to phase 21's logits.  Returns the
    prefill's launch counts."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed import param_specs
    from repro_torch.distributed.sharding import spec_placements
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh()
    try:
        log(f"  host mesh: {mesh}, backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}")
        check(tuple(mesh.shape) == (1, 1)
              and mesh.mesh_dim_names == ("data", "model")
              and mesh.device_type == "cuda"
              and dist.get_backend() == "nccl",
              f"make_host_mesh() gave {mesh} over {dist.get_backend()}")
        specs = param_specs(model.cfg, params, mesh, "tp")
        t0 = time.perf_counter()
        shards = {k: distribute_tensor(v, mesh, spec_placements(specs[k],
                                                                mesh))
                  for k, v in params.items()}
        local = {k: d.to_local() for k, d in shards.items()}
        torch.cuda.synchronize()
        sharded = sum(any(a is not None for a in sp)
                      for sp in specs.values())
        same = [k for k in params if torch.equal(local[k], params[k])
                and local[k].dtype == params[k].dtype]
        log(f"  {len(params)} params placed ({sharded} with a sharded "
            f"spec, every axis of size 1) in "
            f"{time.perf_counter() - t0:.3f} s; local shards bit-identical "
            f"{len(same)} of {len(params)}")
        check(len(same) == len(params), "a local shard differs from its "
              f"param: {sorted(set(params) - set(same))[:4]}")
        batch = prefill_batch(dev, model.cfg)
        with torch.no_grad():
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, _, _ = model.forward(local, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        got_launches = dict(ops.LAUNCHES)
        err = float((got - logits).abs().max())
        log(f"  prefill from the local shards: wall {wall:.3f} s, launches "
            f"{got_launches}; bit-identical to phase 21's "
            f"{torch.equal(got, logits)} (max abs {err:.3e})")
        for name in ("flash_attention", "rmsnorm"):
            check(got_launches[name] == launches[name],
                  f"{name} launched {got_launches[name]} times from the "
                  f"shards, {launches[name]} in phase 21")
        check(torch.equal(got, logits), "the prefill from the host mesh's "
              "local shards is not bit-identical to phase 21's")
        del shards, local, got
    finally:
        dist.destroy_process_group()
    return got_launches


def phase_dryrun():
    """Phase 25: ``dry_run`` of each of ``DRYRUN_CASES`` at published
    widths on the fake world of 512 ranks (this lane's own process: the
    fake group is process-global), each record printed on a line of its
    own; each must be ok with bytes a device and FLOPs above 0, and
    whether its bytes a device fit the card's 80 GB is printed (a count
    of the trace, not a measurement)."""
    from repro_torch.launch import dryrun

    dryrun.force_world(512)
    for arch, shape, mesh, mode, cp in DRYRUN_CASES:
        rec = dryrun.dry_run(arch, shape, multi_pod=mesh == "multi",
                             sharding_mode=mode, context_parallel=cp,
                             verbose=False)
        log("  " + json.dumps(rec))
        per = rec["memory"]["bytes_per_device"]
        log(f"  {arch} x {shape} x {mesh} ({mode}"
            + (", context parallel" if cp else "") + f"): trace "
            f"{rec['trace_s']} s, {per / 1e9:.2f} GB a device (arguments "
            f"{rec['memory']['argument_size_in_bytes'] / 1e9:.2f} GB), "
            f"{'fits' if per <= CARD_BYTES else 'does not fit'} the "
            f"card's {CARD_BYTES / 1e9:.0f} GB (a count); flops "
            f"{rec['cost']['flops']:.3e} a rank; collectives "
            f"{rec['collectives']['total_bytes'] / 1e9:.2f} GB "
            f"{rec['collectives']['counts']}")
        check(rec["ok"] and per > 0 and rec["cost"]["flops"] > 0,
              f"the dry run of {arch} x {shape} x {mesh} ({mode}) is not "
              "ok or counts nothing")


# ---------------------------------------------------------------------------
# phases 22-24: the xLSTM, audio and VLM LM families
# ---------------------------------------------------------------------------

def phase_lm_xlstm(dev):
    """Phase 22; returns the launch counts of the prefill and of the
    served run."""
    from repro_torch.configs import get_config

    cfg = get_config(XLSTM_ARCH)
    check_lm_memory(dev, XLSTM_MIN_FREE_GIB,
                    f"phase 22 ({cfg.arch_id}: 0.29 GiB of fp32 weights; "
                    "the mLSTM's (B, S, H, hd+1, hd) buffers of the "
                    "prefill, 2.3 GiB each)")
    model, params = draw_lm(dev, cfg)
    log(f"  (ModelConfig.param_count's analytic count: "
        f"{cfg.param_count():,}; it halves a pair of blocks and counts no "
        f"bias)")
    log(f"  (a) prefill of {LM_PREFILL_S} tokens: each sLSTM block is "
        f"{LM_PREFILL_S} dependent cell steps")
    launches = lm_prefill(dev, model, params, twin_depth=XLSTM_TWIN_DEPTH,
                          warm=False)[0]
    log("  (b) serving")
    return launches, lm_serve(dev, model, params)


def phase_lm_audio(dev):
    """Phase 23; returns the launch counts of the forward, of the served
    run (over the zero encoder ``init_decode_state`` makes) and of the
    decode run over the forward's frames."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    cfg = get_config(AUDIO_ARCH)
    check_lm_memory(dev, AUDIO_MIN_FREE_GIB,
                    f"phase 23 ({cfg.arch_id}: 0.14 GiB of fp32 weights, "
                    "the forward's logits 0.37 GiB)")
    model, params = draw_lm(dev, cfg)
    b, frames, text = (AUDIO_SHAPE[k] for k in ("batch", "frames", "text"))
    gen = torch.Generator(device=dev).manual_seed(3)
    # the frontend stub's frame embeddings, drawn from a seed
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, text),
                                     generator=gen, device=dev),
             "encoder_embeddings": torch.randn(b, frames, cfg.d_model,
                                               generator=gen, device=dev)}
    log(f"  (a) forward, batch {b}: {frames} encoder frames (30 s of "
        f"audio) and {text} text tokens")
    launches, _, _, _, logits = lm_prefill(dev, model, params, batch=batch)
    s_enc = max(1, int(sum(LM_SERVE[k] for k in ("prompt_len", "gen"))
                       * cfg.enc_seq_frac))
    log(f"  (b) serving over the zero encoder of {s_enc} frames that "
        f"init_decode_state makes for a cache of "
        f"{LM_SERVE['prompt_len'] + LM_SERVE['gen']}")
    slaunches = lm_serve(dev, model, params, fwd_extra={
        "encoder_embeddings": torch.zeros(LM_SERVE["batch"], s_enc,
                                          cfg.d_model, device=dev)})
    log(f"  (c) {text} decode steps over the forward's {frames} frames "
        f"against its logits")
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        st = model.init_decode_state(params, b, text, dtype=torch.float32,
                                     enc_embeddings=batch[
                                         "encoder_embeddings"])
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        err = torch.zeros((), device=dev)
        max_abs = torch.zeros((), device=dev)
        for t in range(text):
            lg, st = model.decode_step(params, st,
                                       batch["tokens"][:, t:t + 1], t)
            gap = (lg - logits[:, t:t + 1]).abs()
            max_abs = torch.maximum(max_abs, gap.max())
            err = torch.maximum(err, (gap / (DECODE_TOL + DECODE_TOL
                                             * logits[:, t:t + 1].abs())
                                      ).max())
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dlaunches = dict(ops.LAUNCHES)
    st_attn, st_norm = lm_decode_state_launches(cfg)
    log(f"  decode state (the encoder over {frames} frames, K/V of "
        f"{cfg.n_layers} decoder layers): {t_enc:.3f} s; {text} steps: "
        f"{1e3 * (wall - t_enc) / text:.2f} ms a step; logits max abs "
        f"{float(max_abs):.3e} from the forward's (max|logits| "
        f"{float(logits.abs().max()):.3f}); the worst "
        f"step's |decode − forward| / ({DECODE_TOL:g} + {DECODE_TOL:g}·"
        f"|forward|) {float(err):.3f} (at most 1 passes); launches "
        f"{dlaunches}")
    check(float(err) <= 1.0, f"decode is not within rtol = atol = "
          f"{DECODE_TOL:g} of the forward ({float(err):.3f} of it)")
    check(dlaunches["flash_attention"] == st_attn
          and dlaunches["rmsnorm"] == st_norm
          + text * lm_norm_launches(cfg, decode=True),
          f"the decode run launched {dlaunches}")
    return launches, slaunches, dlaunches


def phase_lm_vlm(dev):
    """Phase 24; returns the launch counts of the prefill and of the
    served run."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(VLM_ARCH)
    check_lm_memory(dev, VLM_MIN_FREE_GIB,
                    f"phase 24 ({cfg.arch_id}: 47.58 GiB of fp32 weights, "
                    "and the prefill)")
    model, params = draw_lm(dev, cfg)
    p = model._n_patches(LM_PREFILL_S)
    text = model._text_len(LM_PREFILL_S)
    gen = torch.Generator(device=dev).manual_seed(4)
    # the ViT stub's patch embeddings, drawn from a seed
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, text),
                                     generator=gen, device=dev),
             "patch_embeddings": torch.randn(1, p, cfg.d_model,
                                             generator=gen, device=dev)}
    log(f"  (a) prefill of {LM_PREFILL_S} positions: {p} patch embeddings "
        f"and {text} tokens")
    launches = lm_prefill(dev, model, params, batch=batch,
                          twin_depth=VLM_TWIN_DEPTH)[0]
    log("  (b) serving (the dense decode: the tokens never see a patch)")
    return launches, lm_serve(dev, model, params, fwd_extra={
        "patch_embeddings": torch.zeros(LM_SERVE["batch"], 0, cfg.d_model,
                                        device=dev)})


T0 = time.time()          # the script's start, shared with its lanes
PHASE_SECONDS = {}
# what a lane hands the script besides its launches and phase seconds
# (the sync lane: phase 3's (M, k) of kernels 2 and 3)
LANE_RESULTS = {}


# (source, kernel) of each kernel whose contract is a rounded product
# and then a rounded add a term: the pairwise kernel (1 and 4), the
# passes of kernels 5 and 6, kernel 2's walk and kernel 3's walk and B
# segments
SUM_LOOP_KERNELS = (("pairwise_l2.cu", "pairwise_l2_kernel"),
                    ("kmedoids_from_feats.cu", "from_feats_distances"),
                    ("kmedoids_from_feats.cu", "from_feats_column_walk"),
                    ("kmedoids_from_feats.cu", "from_feats_sweep_product"),
                    ("build_cost.cu", "build_cost_walk"),
                    ("delta_sweep.cu", "delta_sweep_walk"),
                    ("delta_sweep.cu", "delta_sweep_segments"))


def check_sum_loops_sass():
    """The k-loops of the pairwise kernel and of kernels 5 and 6's
    distance pass, and the i-loops of their column walks and Δ-sweep
    product, of kernel 2's walk and of kernel 3's walk and B segments,
    hold no FFMA (``tools/kernel_sass.py`` on ``cuobjdump -sass`` of the
    built libraries): a multiply-add contracted by some compiler would
    change the bits."""
    import re

    sys.path.insert(0, str(ROOT / "tools"))
    import kernel_sass

    sass = {}
    for source, kernel in SUM_LOOP_KERNELS:
        if source not in sass:
            sass[source] = kernel_sass.disassemble(source)
        loops = kernel_sass.fused_in_sum_loops(sass[source], kernel)
        check(bool(loops) and all(loops.values()),
              f"no sum loop found in {kernel}'s SASS: {loops}")
        for name, ffma in sorted(loops.items()):
            t = re.search(kernel + r"I((?:L[ib]\d+E)+)E", name)
            shown = (f"{kernel}<" + ", ".join(
                str(int(v)) if kind == "i" else ("true" if v == "1"
                                                 else "false")
                for kind, v in re.findall(r"L([ib])(\d+)E", t[1])) + ">"
                     if t else name)
            log(f"    {shown}: {len(ffma)} sum loop(s), FFMA in them "
                f"{sum(ffma)}")
        check(not any(sum(v) for v in loops.values()),
              f"FFMA in a sum loop of {kernel}: {loops}")


@contextlib.contextmanager
def phase(key, title):
    """Log the phase's title with the seconds since the script's start;
    record its seconds under ``key``."""
    log(f"[{time.time() - T0:.0f} s] == phase {title}")
    t = time.perf_counter()
    yield
    PHASE_SECONDS[key] = time.perf_counter() - t


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else
            f"{torch.cuda.get_device_name(0)}, power limit not read")


def setup_torch():
    """TF32 off and deterministic cuDNN, in every process of the run."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuDNN: the kernel and plain runs of phases 3 and 4
    # must train bit for bit alike, or a last-bit difference in the
    # parameters reaches the next round's medoid choice
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def char_lm_clients():
    """Phases 8-11's 200 char-LM clients at the paper's Table-1 sizes
    (lognormal, mean 69, std 106)."""
    from repro_torch.fed.fleet import get_workload

    return get_workload("translm").make_clients(
        n_clients=200, seed=0, mean_samples=69.0, std_samples=106.0)


def lane_sync_cnn():
    """Phases 3-7, 12, 14 and 15; returns the launch counts of the sync,
    CNN fleet, async and async fleet paths, and of phase 15's resumed
    fleet, resumed async fleet and projected sync round."""
    with phase("main_path", "3: main path, FedCore on SmallCNN (28x28, "
               "16/32, F=1568), 200 clients, 3 rounds x 10 clients, E=5"):
        clients, cfg, kout, kstrat, launches, shapes = phase_main_path()
    LANE_RESULTS["sync_shapes"] = shapes
    with phase("plain_ab", "4: the same run with use_kernel=False"):
        phase_plain_ab(clients, cfg, kout, kstrat)
    with phase("other_models", "5: the other paper models"):
        phase_other_models()
    with phase("fleet", "6: fleet main path, run_fleet(engine='batched') "
               "on SmallCNN (28x28, 16/32, F=1568), 200 clients, every "
               "client every round, 3 rounds, E=5"):
        wl, fclients, fspecs, fcfg, fkept, flaunches, fout = phase_fleet()
    with phase("fleet_ab", "7: fleet A/Bs, use_kernel=False and "
               "engine='loop'"):
        phase_fleet_ab(wl, fclients, fspecs, fcfg, fkept, PARAMS_ATOL_CNN,
                       len(fkept))
    with phase("async", "12: async main path, run_federated_async with "
               "FedCore on SmallCNN (28x28, 16/32, F=1568), phase 3's 200 "
               "clients, FedBuff(10), 3 updates, concurrency 10, E=5"):
        alaunches = phase_async(clients)
    with phase("async_fleet", "14: async fleet main path, "
               "run_async_fleet(engine='batched') on phase 6's fleet, "
               "FedBuff, 3 flushes of 32, concurrency 64, E=5; its plain "
               "twin, the loop engine, a faulted async_fleet scenario"):
        aflaunches, aout = phase_async_fleet(wl, fclients, fspecs)
    with phase("resume", "15: checkpoint and resume of phase 6's fleet and "
               "phase 14's async fleet; phase 3's round at projection_dim="
               "256 and its plain twin; the ε audit"):
        log(f"  card: {card_line()}")
        rlaunches = phase_fleet_resume(wl, fclients, fspecs, fcfg, fout)
        arlaunches = phase_async_fleet_resume(wl, fclients, fspecs, aout)
        plaunches = phase_projected_sync(clients, cfg)
        phase_epsilon_audit(clients, kout["params"])
    return {"sync": launches, "fleet": flaunches, "async": alaunches,
            "async_fleet": aflaunches,
            "fleet_resume": rlaunches, "async_fleet_resume": arlaunches,
            "sync_projected": plaunches}


def lane_translm():
    """Phases 8-9; returns the launch counts of the translm fleet."""
    import torch

    with phase("translm", "8: translm fleet, run_fleet(engine='batched') "
               "on CharTransformer (d_model 32, 2 heads of 16, d_ff 64, "
               "S=16), 200 clients, every client every round, 3 rounds, "
               "E=5"):
        twl, tclients, tspecs, tcfg, tgroups = translm_fleet()
        tkept, tlaunches = phase_translm(twl, tclients, tspecs, tcfg,
                                         tgroups)
    with phase("translm_ab", "9: translm A/Bs, (a) use_kernel=False, (b) "
               "engine='loop', (c) the attention kernel against naive "
               "attention"):
        plaunches, _ = phase_fleet_ab(twl, tclients, tspecs, tcfg, tkept,
                                      PARAMS_ATOL_TRANSLM, len(tkept))
        check(plaunches["flash_attention"] > 0,
              "the plain-selection run did not launch the attention "
              "kernel")
        attention_kernel_vs_naive(twl, tgroups, torch.device("cuda"))
    return {"fleet_translm": tlaunches}


def lane_xlstm():
    """Phases 10, 11 and 13; returns the launch counts of the xlstm fleet
    and of the faulted CNN fleet."""
    with phase("xlstm", "10: xlstm fleet, run_fleet(engine='batched') on "
               "CharXLSTM (d_model 32, 2 heads of 16, S=16), 200 clients, "
               "every client every round, 3 rounds, E=5"):
        xwl, xclients, xspecs, xcfg, xgroups = xlstm_fleet(char_lm_clients())
        xkept, xlaunches = phase_xlstm(xwl, xclients, xspecs, xcfg, xgroups)
    with phase("xlstm_ab", "11: xlstm A/Bs, (a) use_kernel=False selection, "
               "(b) the plain RMSNorm, (c) engine='loop', (d) the scenario "
               "registry's fleet and sync runtimes"):
        phase_xlstm_ab(xwl, xclients, xspecs, xcfg, xkept)
    with phase("fleet_faults", "13: faults on the CNN fleet, 'hostile' with "
               "the trimmed mean, the robust rules under 'byzantine_boost', "
               "a faulted sync scenario"):
        # phase 6's fleet and phase 3's clients, made anew from their
        # seeds: this lane is the shortest of the three without it
        from repro_torch.data import mnist_like_dataset

        wl = cnn_fleet_workload()
        fclients = wl.make_clients()
        fspecs, fcfg, _ = fleet_setup(wl, fclients)
        flaunches = phase_fleet_faults(
            wl, fclients, fspecs, fcfg,
            mnist_like_dataset(n_clients=200, seed=0))
    return {"fleet_xlstm": xlaunches, "fleet_faults": flaunches}


def lane_lm():
    """Phases 16-18; returns the launch counts of the LM paths: serving,
    prefill, training and FedCore-for-LM."""
    import gc

    import torch

    dev = torch.device("cuda")
    with phase("lm_serve", "16: LM serving, generate on yi-9b (48 layers, "
               "d_model 4096, 32/4 heads, d_ff 11008, vocab 64000, fp32), "
               "batch 4, prompt 16, 32 greedy tokens"):
        model, params, slaunches = phase_lm_serve(dev)
    with phase("lm_prefill", "17: LM prefill, Model.forward on yi-9b, one "
               "4,096-token sequence, kernel 7 against its plain twin and "
               "chunked attention"):
        plaunches = phase_lm_prefill(dev, model, params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_train", "18: LM training at yi-9b's widths, depth 2: "
               "train_centralized (Adam, 20 steps) and train_fedcore_lm (2 "
               "rounds, 4 silos, F = 4096) with its plain twin"):
        tlaunches, flaunches, shapes = phase_lm_train(dev)
    LANE_RESULTS["lm_shapes"] = shapes
    return {"lm_serve": slaunches, "lm_prefill": plaunches,
            "lm_train": tlaunches, "lm_fedcore": flaunches}


def lane_sharded():
    """Phase 19; returns the launch counts of the sharded fleet paths and
    of the fused selection."""
    with phase("sharded", "19: the sharded fleet on phase 6's fleet: "
               "select_group_coresets, the cost model, one NCCL rank, "
               f"{SHARDED_RANKS} gloo ranks sharing the card"):
        log(f"  card: {card_line()}")
        import torch

        launches = phase_sharded(
            torch.device("cuda", torch.cuda.current_device()))
    return launches


def lane_lm_families():
    """Phases 20-24; returns the launch counts of the MoE, hybrid, xLSTM,
    audio and VLM LM paths: prefill and serving of each, and the audio
    model's decode over its frames."""
    import gc

    import torch

    dev = torch.device("cuda")
    with phase("lm_moe", "20: MoE LM, llama4-scout-17b-a16e at its "
               "published widths (d_model 5120, 40/8 heads of 128, d_ff "
               "8192, 16 experts top-1 + a shared expert, vocab 202048, "
               f"fp32), depth cut to {MOE_DEPTH} layers: prefill of "
               f"{LM_PREFILL_S} tokens, generate with batch 4, prompt 16, "
               "32 greedy tokens"):
        log(f"  card: {card_line()}")
        mprefill, mserve = phase_lm_moe(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_hybrid", "21: hybrid LM, zamba2-1.2b at its published "
               "widths and depth (38 Mamba2 layers, d_model 2048, d_inner "
               "4096, 64 SSM heads of 64, state 64, chunk 128, a shared "
               "attention block every 6, 32/32 heads of 64, tied vocab "
               f"32000, fp32): prefill of {LM_PREFILL_S} tokens, generate "
               "with batch 4, prompt 16, 32 greedy tokens"):
        hprefill, hserve, (hmodel, hparams, hlogits) = phase_lm_hybrid(dev)
    with phase("host_mesh", "26: zamba2-1.2b's params on make_host_mesh() "
               "(1 x 1, NCCL) by param_specs as DTensors, phase 21's "
               "prefill from the local shards"):
        mlaunches = phase_host_mesh(dev, hmodel, hparams, hlogits, hprefill)
    del hmodel, hparams, hlogits
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_xlstm", "22: xLSTM LM, xlstm-125m at its published "
               "widths and depth (blocks msmsmsmsmsms, d_model 768, 4 "
               "heads of 192, tied vocab 50304, fp32): prefill of "
               f"{LM_PREFILL_S} tokens, generate with batch 4, prompt 16, "
               "32 greedy tokens"):
        xprefill, xserve = phase_lm_xlstm(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_audio", "23: audio LM, whisper-tiny at its published "
               "widths and depth (4 + 4 layers, d_model 384, 6 heads of "
               "64, d_ff 1536, vocab 51865, fp32): forward over 4 x (1,500 "
               "frames + 448 tokens), generate with batch 4, prompt 16, 32 "
               "greedy tokens, 448 decode steps over the frames"):
        aprefill, aserve, adecode = phase_lm_audio(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("lm_vlm", "24: VLM, pixtral-12b at its published widths "
               "and depth (40 layers, d_model 5120, 32/8 heads of 160, "
               "d_ff 14336, vocab 131072, fp32): prefill of 1,024 patches "
               "and 3,072 tokens, generate with batch 4, prompt 16, 32 "
               "greedy tokens"):
        vprefill, vserve = phase_lm_vlm(dev)
    return {"lm_moe_prefill": mprefill, "lm_moe_serve": mserve,
            "lm_hybrid_prefill": hprefill, "lm_hybrid_serve": hserve,
            "lm_host_mesh": mlaunches,
            "lm_xlstm_prefill": xprefill, "lm_xlstm_serve": xserve,
            "lm_audio_prefill": aprefill, "lm_audio_serve": aserve,
            "lm_audio_decode": adecode, "lm_vlm_prefill": vprefill,
            "lm_vlm_serve": vserve}


def lane_dryrun():
    """Phase 25; uses no card, so it launches no kernel.  It runs at the
    lowest CPU priority, so that the host-bound phases of lane
    ``lm_families`` beside it keep their cores."""
    os.nice(19)
    with phase("dryrun", "25: the shape-only dry run at published widths "
               f"on the fake world's production meshes, {len(DRYRUN_CASES)} "
               "combinations"):
        phase_dryrun()
    return {}


def lane_main(name: str, parent: int) -> int:
    """One lane, started by ``main``: dies with its parent, runs its
    phases and writes {"launches": {path: counts}, "phases": {key: s}}
    to ``build/chip_smoke/<name>.json``."""
    import ctypes

    # PR_SET_PDEATHSIG: stopped with SIGKILL if the script that started
    # it ends first
    ctypes.CDLL(None).prctl(1, signal.SIGKILL)
    if os.getppid() != parent:
        return 1
    sys.path.insert(0, str(SRC))
    import torch

    torch.set_num_threads(2)
    setup_torch()
    launches = {"sync_cnn": lane_sync_cnn, "translm": lane_translm,
                "xlstm": lane_xlstm, "lm": lane_lm,
                "sharded": lane_sharded,
                "lm_families": lane_lm_families,
                "dryrun": lane_dryrun}[name]()
    tmp = LANE_DIR / f"{name}.json.tmp"
    tmp.write_text(json.dumps({"launches": launches,
                               "phases": PHASE_SECONDS, **LANE_RESULTS}))
    tmp.replace(LANE_DIR / f"{name}.json")
    return 0


def run_children(argv):
    """Start ``python3 chip_smoke.py *argv[name] PID`` for each name (a
    lane or a rank, its output to ``build/chip_smoke/<name>.log``), wait
    for all of them, print their output in order; any child's failure,
    or ``LANE_DEADLINE_S``, stops the others.  Returns the names that
    failed or were stopped."""
    procs, logs = {}, {}
    env = dict(os.environ, CHIP_SMOKE_T0=repr(T0))
    try:
        for name, args in argv.items():
            logs[name] = open(LANE_DIR / f"{name}.log", "w")
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), *args,
                 str(os.getpid())], cwd=ROOT, env=env,
                stdout=logs[name], stderr=subprocess.STDOUT)
        log(f"  {', '.join(argv)} started")
        while True:
            codes = {n: p.poll() for n, p in procs.items()}
            failed = [n for n, c in codes.items() if c not in (None, 0)]
            if failed or all(c == 0 for c in codes.values()):
                break
            if time.time() - T0 > LANE_DEADLINE_S:
                failed = [n for n, c in codes.items() if c is None]
                break
            time.sleep(0.5)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs.values():
            f.close()
    for name in argv:
        log(f"-- {name} (exit {procs[name].returncode}):")
        sys.stdout.write((LANE_DIR / f"{name}.log").read_text())
        sys.stdout.flush()
    return failed


def run_lanes(lanes):
    """Start ``lanes``, wait for all of them, print their output in
    order; returns their merged launch counts and phase seconds and the
    sync and LM FedCore paths' (M, k) of kernels 2 and 3.  Any lane's
    failure stops the others and fails the phase, as does the
    deadline."""
    failed = run_children({name: ["--lane", name] for name in lanes})
    check(not failed, f"lane(s) {', '.join(failed)} failed or were stopped "
          f"(deadline {LANE_DEADLINE_S:.0f} s)")
    by_path, phases, shapes = {}, {}, {"sync": [], "lm": []}
    for name in lanes:
        res = json.loads((LANE_DIR / f"{name}.json").read_text())
        by_path.update(res["launches"])
        phases.update(res["phases"])
        for path in shapes:
            shapes[path] += [tuple(s) for s in res.get(f"{path}_shapes", ())]
    return by_path, phases, shapes


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this script measures the "
              "port on the card only", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    # the lanes' processes end with this one, however it ends
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))

    log("== phase 1: set-up")
    card = card_line()
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    setup_torch()
    log("  TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False; "
        "torch.backends.cudnn.deterministic = True")
    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"  kernels built in {secs:.2f} s (nvcc, sm_90a, in parallel)")
    for name, text in _build.BUILD_LOG.items():
        for line in text.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill", "error")):
                log(f"    {name}: {line.strip()}")
    check_sum_loops_sass()
    dev = torch.device("cuda")

    with phase("kernels", "2: kernels against their plain versions (rtol "
               "1e-5, atol 1e-5*max|plain|)"):
        kernels = phase_kernels(dev, kernel_cases(dev, *phase2_groups(dev)))
    # hand the lanes the memory phase 2 left cached (yi-9b needs 40 GiB)
    torch.cuda.empty_cache()
    import shutil

    shutil.rmtree(LANE_DIR, ignore_errors=True)
    LANE_DIR.mkdir(parents=True)
    log(f"[{time.time() - T0:.0f} s] == phases 3-15 in three concurrent "
        f"lanes: 3-7, 12, 14 and 15 ({LANES[0]}), 8-9 ({LANES[1]}), 10, "
        f"11 and 13 ({LANES[2]})")
    by_path, lane_phases, solve_shapes = run_lanes(LANES)
    log(f"[{time.time() - T0:.0f} s] == phases 16-18 in lane "
        f"{LM_LANES[0]}, alone: its GPU-bound prefill would stretch the "
        f"host-bound lanes' waits on the card")
    lm_path, lm_phases, lm_shapes = run_lanes(LM_LANES)
    log(f"[{time.time() - T0:.0f} s] == phase 19 in lane "
        f"{SHARDED_LANES[0]}, alone: its {SHARDED_RANKS} ranks are two more "
        f"processes on the card")
    sh_path, sh_phases, _ = run_lanes(SHARDED_LANES)
    log(f"[{time.time() - T0:.0f} s] == phases 20-24 and 26 in lane "
        f"{FAMILY_LANES[0]}, its prefills GPU-bound as lane "
        f"{LM_LANES[0]}'s, beside phase 25 in lane {FAMILY_LANES[1]}, "
        f"which uses no card")
    fam_path, fam_phases, _ = run_lanes(FAMILY_LANES)
    PHASE_SECONDS.update(lane_phases)
    for paths, phases in ((lm_path, lm_phases), (sh_path, sh_phases),
                          (fam_path, fam_phases)):
        by_path.update(paths)
        PHASE_SECONDS.update(phases)
    solve_shapes["lm"] += lm_shapes["lm"]
    with phase("kernels_sync", "2, continued: kernels 2 and 3 at the sync "
               "path's (M, K) of phase 3 and the LM FedCore path's of "
               "phase 18"):
        phase_kernels(dev, sync_cases(dev, solve_shapes["sync"])
                      + sync_cases(dev, solve_shapes["lm"], "lm"), kernels)

    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      PHASE_SECONDS.items())
        + f"; total {time.time() - T0:.1f}")
    line = {"kernels": []}
    check(all(by_path[p]["rmsnorm"] > 0
              for p in ("fleet_translm", "fleet_xlstm")),
          "the RMSNorm kernel did not launch on both char-LM fleets")
    for name, (source, replaces) in KERNEL_META.items():
        k = kernels[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[PATH_OF[name]][name],
            "max_abs_err": k["max_abs_err"],
            "max_abs_err_exact": k["max_abs_err_exact"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "device_ms": k["device_ms"],
            "shape": k["shape"], "path": PATH_OF[name], "cases": k["cases"],
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if os.environ.get("CHIP_SMOKE_T0"):
        T0 = float(os.environ["CHIP_SMOKE_T0"])
    try:
        if len(sys.argv) == 4 and sys.argv[1] == "--lane":
            sys.exit(lane_main(sys.argv[2], int(sys.argv[3])))
        if len(sys.argv) == 5 and sys.argv[1] == "--rank":
            sys.exit(sharded_rank_main(*map(int, sys.argv[2:])))
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
