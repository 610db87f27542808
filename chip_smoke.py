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
   16, 24, 32), the ``translm`` fleet's own shapes and yi-9b's attention
   for one 4096-token sequence, with ``scaled_dot_product_attention``
   timed as the library yardstick: in fp32 (the SIMT kernel) it must
   agree with the plain version exactly, in bf16 (the tensor-core kernel,
   whose wgmma sums run in the hardware's order) it must be within 2e-2
   of it and its max and mean error against a float64 oracle at most 2x
   SDPA's (``bf16_attention_rule``), and its profile must show the wgmma
   kernel; RMSNorm at the JAX kernel test's shapes, the fleets' vmapped
   step (84 clients' scales, one group each), xlstm-125m's and yi-9b's
   widths, fp32 and bf16, which must agree with the plain version
   exactly, with ``torch.nn.functional.rms_norm`` timed as the yardstick;
   the cases with a shape key (the step shapes, yi-9b) also print the
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
    through the RMSNorm kernel.

Phases 1-2 run alone.  Phases 3-7 (the sync runtime and the CNN fleet),
8-9 (the ``translm`` fleet) and 10-11 (the ``xlstm`` fleet) share no
state, and each group is host-bound (the card idles most of each round),
so they run as three concurrent processes on the one card, each a
*lane* (``python3 chip_smoke.py --lane NAME``, started by the script
itself): a lane sets its own launch counts to 0 around its main path,
writes its launch counts and phase seconds to ``build/chip_smoke/``, and
its output is printed in phase order once every lane has ended.  Round
walls, idle shares and step times of phases 3-11 are therefore taken
with the other two lanes running.  A lane that fails stops the others;
lanes still running ``LANE_DEADLINE_S`` seconds after the start are
stopped and the script fails with what they printed so far.

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
# the lanes of phases 3-11, run concurrently (see the module docstring)
LANES = ("sync_cnn", "translm", "xlstm")
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
            "flash_attention": "translm step", "rmsnorm": "yi-9b fp32"}
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
           "flash_attention": "fleet_translm", "rmsnorm": "fleet_xlstm"}
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
    a warm-up (inputs stay warm in L2, as the main path leaves them)."""
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
    # a call of seconds (plain attention at yi-9b) needs few repeats
    reps = int(max(2 if one > 500.0 else 5, min(200, target_ms / one)))
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
    for m, d in ((37, 60), (39, 1568), (341, 1568), (1000, 1568),
                 (2048, 1568), (2048, 128)):
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


def sync_cases(dev, shapes):
    """Kernels 2 and 3 at the sync path's own shapes: ``shapes`` holds
    the (M, k) of phase 3's solves; kernel 2 at each M, kernel 3 at each
    (M, k) with a one-hot H."""
    import torch

    g = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for m in sorted({m for m, _ in shapes}):
        D, d1, _, vf = sweep_inputs(g, 1, m, dev)
        cases.append(build_cost_case(f"C=1 M={m} (sync)", (1, m, "sync"),
                                     D, d1, vf))
    for m, k in sorted(set(shapes)):
        D, d1, d2, vf = sweep_inputs(g, 1, m, dev)
        cases.append(delta_sweep_case(f"M={m} K={k} (sync)",
                                      (m, k, "sync"), D, d1, d2, vf,
                                      onehot(g, 1, m, k, dev)))
    return cases


def attention_cases(dev, g, attn_shapes):
    """Flash attention (kernel 7) cases in ``kernel_cases``'s form, all
    causal, at (B, Hq, Hk, S, hd, window, dtype, what, shape key).  fp32
    runs the SIMT kernel, which must equal its plain version exactly
    (packed blocks for S <= 32); bf16 the tensor-core kernel, held by
    ``bf16_attention_rule``."""
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
    cases = []
    for b, hq, hk, s, hd, window, dt, what, key in shapes:
        q = torch.randn(b, hq, s, hd, generator=g, device=dev).to(dt)
        k = torch.randn(b, hk, s, hd, generator=g, device=dev).to(dt)
        v = torch.randn(b, hk, s, hd, generator=g, device=dev).to(dt)

        def run(uk, q=q, k=k, v=v, window=window):
            return (ops.flash_attention(q, k, v, window=window,
                                        use_kernel=uk),)

        mask = ref.attention_mask(s, True, window, dev)

        def lib(q=q, k=k, v=v, mask=mask, windowed=window is not None,
                gqa=hq != hk):
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask if windowed else None,
                is_causal=not windowed, enable_gqa=gqa)

        # the work: 4·hd operations per visible (q, k) pair and head (the
        # score and the weighted sum of V); each of q, k, v read once and
        # the output written once
        pairs = float(mask.sum())
        label = (f"B={b} Hq={hq} Hk={hk} S={s} hd={hd}"
                 + (f" window={window}" if window else "")
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
               ((4096, 768), 1, f32, "xlstm-125m width", None)]
    shapes += [((4096, 4096), 1, dt, "yi-9b width",
                "yi-9b " + ("bf16" if dt == bf16 else "fp32"))
               for dt in (f32, bf16)]
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
        _, busy, by_name = device_busy_share(
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
            _, lbusy, _ = device_busy_share(
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


def run_fl(model, clients, cfg, use_kernel=None):
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
        FedCoreConfig(use_kernel=use_kernel))
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
    import numpy as np
    import torch

    from repro_torch.core.coreset import build_coreset
    from repro_torch.core.kmedoids import medoid_objective_f64
    from repro_torch.models import SmallCNN

    pout, pstrat, _, launches, wall = run_fl(SmallCNN(), clients, cfg,
                                             use_kernel=False)
    log(f"  plain run: wall {wall:.2f} s, launches {launches}")
    check(all(n == 0 for n in launches.values()),
          f"use_kernel=False launched a kernel: {launches}")
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


def run_fleet_recorded(wl, clients, specs, cfg, rounds, engine):
    """One ``run_fleet`` on the card with recording on, keeping each
    round's medoids {cid: indices} and aggregated parameters; returns
    (output, [(medoids, params)] per round, span records, launch counts,
    wall seconds)."""
    import numpy as np
    import torch

    import repro_torch.fed.fleet.batched as fleet_batched
    from repro_torch.fed.fleet import run_fleet
    from repro_torch.kernels import ops
    from repro_torch.obs import InMemorySink, Recorder, use_recorder

    kept = []
    inner = fleet_batched.run_fleet_round

    def recording_round(*args, **kwargs):
        params, stats = inner(*args, **kwargs)
        kept.append(({int(c): np.asarray(m) for c, m in
                      stats.medoids.items()},
                     {k: v.clone() for k, v in params.items()}))
        return params, stats

    sink = InMemorySink()
    fleet_batched.run_fleet_round = recording_round
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with use_recorder(Recorder([sink])):
            out = run_fleet(wl, clients, specs, cfg, rounds,
                            straggler_pct=30.0, engine=engine)
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


def stream_time_by_part(fn):
    """Run ``fn`` with CUDA events around the fleet's per-client
    gradient-feature passes, its selection solves and, inside these, the
    distance-free solver's column rebuilds (BUILD) and medoid-slab
    rebuilds (SWAP); returns {part: (calls, stream seconds)}.  A part's
    time runs from the stream reaching its first operation to the stream
    finishing its last, so it includes the card's waits for the host to
    launch the part's operations.  Host spans cannot split these: the
    feature passes return before the card runs them, and the selection
    span's first host sync waits for them."""
    import torch

    import repro_torch.core.kmedoids as km
    from repro_torch.fed.fleet import FleetEngine

    marks, stack = {}, []

    def timed(part, inner, not_inside=None):
        def wrapper(*args, **kwargs):
            if not_inside in stack:
                return inner(*args, **kwargs)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            stack.append(part)
            start.record()
            try:
                return inner(*args, **kwargs)
            finally:
                end.record()
                stack.pop()
                marks.setdefault(part, []).append((start, end))
        return wrapper

    patches = [(FleetEngine, "_features", "grad_features", None),
               (FleetEngine, "_select", "selection", None),
               (km, "_col_dists", "column rebuilds (BUILD)",
                "medoid-slab rebuilds (SWAP)"),
               (km, "_medoid_dists", "medoid-slab rebuilds (SWAP)", None)]
    saved = [(owner, attr, getattr(owner, attr))
             for owner, attr, _, _ in patches]
    for owner, attr, part, not_inside in patches:
        setattr(owner, attr, timed(part, getattr(owner, attr), not_inside))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for owner, attr, inner in saved:
            setattr(owner, attr, inner)
    return wall, {part: (len(ev), sum(a.elapsed_time(b) for a, b in ev)
                         * 1e-3) for part, ev in marks.items()}


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
    have launched.  Returns (kept rounds, launch counts)."""
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
    return kept, launches


def phase_fleet():
    from repro_torch.fed.fleet import run_fleet

    wl = cnn_fleet_workload()
    clients = wl.make_clients()
    specs, cfg, groups = fleet_setup(wl, clients)
    log_groups(groups)
    kept, launches = fleet_main_run(wl, clients, specs, cfg, FLEET_KERNELS)

    # three more one-round runs, alike but for what watches them: bare
    # (the wall), with CUDA events around the selection's parts, and
    # under torch.profiler
    def one_round():
        return run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)

    bare_wall, busy, by_name = bare_and_profiled(one_round)
    log_kernel_time(by_name, busy, "pairwise", "pairwise_l2_kernel")
    log_kernel_time(by_name, busy, "distance-free (5-6)", "from_feats")
    log_kernel_time(by_name, busy, "BUILD over D (2)", "build_cost_walk")
    log_kernel_time(by_name, busy, "Δ-sweep over D (3)", "delta_sweep_")
    ewall, parts = stream_time_by_part(one_round)
    log(f"  stream time by part (one more round with CUDA events, wall "
        f"{ewall:.3f} s): " + ", ".join(
            f"{part} {n} calls {t:.3f} s ({100 * t / bare_wall:.1f}% of "
            f"the bare round)" for part, (n, t) in parts.items()))
    return wl, clients, specs, cfg, kept, launches


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
    kept, launches = fleet_main_run(wl, clients, specs, cfg,
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
    kept, launches = fleet_main_run(wl, clients, specs, cfg,
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
    """Phases 3-7; returns the launch counts of the sync and CNN fleet
    main paths."""
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
        wl, fclients, fspecs, fcfg, fkept, flaunches = phase_fleet()
    with phase("fleet_ab", "7: fleet A/Bs, use_kernel=False and "
               "engine='loop'"):
        phase_fleet_ab(wl, fclients, fspecs, fcfg, fkept, PARAMS_ATOL_CNN,
                       len(fkept))
    return {"sync": launches, "fleet": flaunches}


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
    """Phases 10-11; returns the launch counts of the xlstm fleet."""
    with phase("xlstm", "10: xlstm fleet, run_fleet(engine='batched') on "
               "CharXLSTM (d_model 32, 2 heads of 16, S=16), 200 clients, "
               "every client every round, 3 rounds, E=5"):
        xwl, xclients, xspecs, xcfg, xgroups = xlstm_fleet(char_lm_clients())
        xkept, xlaunches = phase_xlstm(xwl, xclients, xspecs, xcfg, xgroups)
    with phase("xlstm_ab", "11: xlstm A/Bs, (a) use_kernel=False selection, "
               "(b) the plain RMSNorm, (c) engine='loop', (d) the scenario "
               "registry's fleet and sync runtimes"):
        phase_xlstm_ab(xwl, xclients, xspecs, xcfg, xkept)
    return {"fleet_xlstm": xlaunches}


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
                "xlstm": lane_xlstm}[name]()
    tmp = LANE_DIR / f"{name}.json.tmp"
    tmp.write_text(json.dumps({"launches": launches,
                               "phases": PHASE_SECONDS, **LANE_RESULTS}))
    tmp.replace(LANE_DIR / f"{name}.json")
    return 0


def run_lanes():
    """Start the lanes, wait for all of them, print their output in
    order; returns their merged launch counts and phase seconds and the
    sync path's (M, k) of kernels 2 and 3.  Any lane's failure stops the
    others and fails the phase, as does the deadline."""
    import shutil

    shutil.rmtree(LANE_DIR, ignore_errors=True)
    LANE_DIR.mkdir(parents=True)
    procs, logs = {}, {}
    env = dict(os.environ, CHIP_SMOKE_T0=repr(T0))
    try:
        for name in LANES:
            logs[name] = open(LANE_DIR / f"{name}.log", "w")
            procs[name] = subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--lane",
                 name, str(os.getpid())], cwd=ROOT, env=env,
                stdout=logs[name], stderr=subprocess.STDOUT)
        log(f"  lanes {', '.join(LANES)} started")
        while True:
            codes = {n: p.poll() for n, p in procs.items()}
            failed = [n for n, c in codes.items() if c not in (None, 0)]
            if failed or all(c == 0 for c in codes.values()):
                break
            if time.time() - T0 > LANE_DEADLINE_S:
                failed = [n for n, c in codes.items() if c is None]
                break
            time.sleep(1.0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs.values():
            f.close()
    for name in LANES:
        log(f"-- lane {name} (exit {procs[name].returncode}):")
        sys.stdout.write((LANE_DIR / f"{name}.log").read_text())
        sys.stdout.flush()
    check(not failed, f"lane(s) {', '.join(failed)} failed or were stopped "
          f"(exits {[procs[n].returncode for n in failed]}; deadline "
          f"{LANE_DEADLINE_S:.0f} s)")
    by_path, phases, shapes = {}, {}, []
    for name in LANES:
        res = json.loads((LANE_DIR / f"{name}.json").read_text())
        by_path.update(res["launches"])
        phases.update(res["phases"])
        shapes += [tuple(s) for s in res.get("sync_shapes", ())]
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
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
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
    log(f"[{time.time() - T0:.0f} s] == phases 3-11 in three concurrent "
        f"lanes: 3-7 ({LANES[0]}), 8-9 ({LANES[1]}), 10-11 ({LANES[2]})")
    by_path, lane_phases, sync_shapes = run_lanes()
    PHASE_SECONDS.update(lane_phases)
    with phase("kernels_sync", "2, continued: kernels 2 and 3 at the sync "
               "path's (M, K) of phase 3"):
        phase_kernels(dev, sync_cases(dev, sync_shapes), kernels)

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
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
