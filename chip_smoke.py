#!/usr/bin/env python3
"""Drive the PyTorch port of FedCore on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card.  The
phases run in order and any failure exits non-zero:

1. set-up: the card's name and power limit, the torch and CUDA versions,
   TF32 off for matrix products and cuDNN convolutions, deterministic
   cuDNN, and the build of
   the six CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   sm_90a, one process per source, compiled in parallel);
2. each kernel against its plain PyTorch version on the card at the main
   paths' shapes: error, kernel / plain / library time, least time (the
   bound), at rtol 1e-5 and atol 1e-5·max|plain| (the two sum in the same
   order and should agree bit for bit; the tolerance is the one a
   reordered float32 sum would need); the 1e30 padded-candidate masks of
   the distance-free kernels must be equal exactly;
3. the main path at full width: ``run_federated`` with ``FedCore`` on
   ``SmallCNN()`` (28x28, channels 16/32, F = 1568) over 200 pseudo-MNIST
   clients (Table 1 sizes: mean 69, std 106), 3 rounds of 10 clients,
   E = 5; the launch counts are set to 0 just before and read just after,
   and every kernel must have launched and every coreset been built on
   the card;
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
   time; the idle share is taken against the bare wall);
7. the fleet A/Bs: the same 3 rounds with ``use_kernel=False`` pick the
   same medoids per (round, client) and end on bit-identical parameters;
   one round of ``engine="loop"`` picks the batched round's medoids and
   ends within the reference's ``PARAMS_ATOL`` (2e-4 for the CNN) of its
   parameters.

The last lines are the card (``nvidia-smi --query-gpu=name,power.limit``),
one JSON object of kernel numbers, and the result line
``{"ok": true, "device": {...}}``.  It prints no result and exits 1
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): fp32 outside the tensor cores
# and HBM3 bandwidth; the bound of a kernel is the larger of its bytes over
# the bandwidth and its operations over the fp32 rate
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
RTOL = 1e-5

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
}
HEADLINE = {"pairwise_l2": (2048, 1568), "build_cost": (1, 2048),
            "delta_sweep": (2048, 700), "pairwise_l2_batched": (16, 128),
            "build_cost_from_feats": (1, 2048),
            "delta_sweep_from_feats": (1, 2048, 130)}
# the main path each kernel belongs to: its launches in the kernels line
# are that path's (every path's counts are printed beside them)
PATH_OF = {"pairwise_l2": "sync", "build_cost": "sync",
           "delta_sweep": "sync", "pairwise_l2_batched": "fleet",
           "build_cost_from_feats": "fleet",
           "delta_sweep_from_feats": "fleet"}
# the kernels each main path must launch
SYNC_KERNELS = ("pairwise_l2", "build_cost", "delta_sweep")
FLEET_KERNELS = ("pairwise_l2_batched", "build_cost_from_feats",
                 "delta_sweep_from_feats", "build_cost", "delta_sweep")
FEATS = 1568            # SmallCNN's feature width at 28x28, channels 16/32
# the reference's loop-vs-batched parameter tolerance
# (tests/test_workload_conformance.py PARAMS_ATOL)
PARAMS_ATOL_CNN = 2e-4


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
    reps = int(max(5, min(200, target_ms / one)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

def kernel_cases(dev):
    """(kernel, label, shape key, run(use_kernel) -> tensors, bytes, ops,
    library call or None) at the main path's shapes."""
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for m, d in ((37, 60), (1000, 1568), (2048, 1568), (2048, 128)):
        x = torch.randn(m, d, generator=g, device=dev)

        def run(uk, x=x):
            return (ops.pairwise_l2(x, squared=True, zero_diag=True,
                                    use_kernel=uk),)

        def lib(x=x):
            return torch.cdist(x, x).square()

        cases.append(("pairwise_l2", f"m={m} d={d}", (m, d), run,
                      4.0 * (m * d + m * m), 2.0 * m * m * d + 4.0 * m * m,
                      lib))
    for c in (1, 4):
        for m in (37, 1000, 2048):
            D = torch.rand(c, m, m, generator=g, device=dev)
            dn = torch.rand(c, m, generator=g, device=dev)
            vf = (torch.rand(c, m, generator=g, device=dev) < 0.9).float()

            def run(uk, D=D, dn=dn, vf=vf):
                return (ops.kmedoids_build_cost(D, dn, vf, use_kernel=uk),)

            cases.append(("build_cost", f"C={c} M={m}", (c, m), run,
                          4.0 * (c * m * m + 3 * c * m), 3.0 * c * m * m,
                          None))
    # the fleet's selection group below the cutover: C=25, M=128, k=64
    D = torch.rand(25, 128, 128, generator=g, device=dev)
    dn = torch.rand(25, 128, generator=g, device=dev)
    vf = (torch.rand(25, 128, generator=g, device=dev) < 0.9).float()

    def run(uk, D=D, dn=dn, vf=vf):
        return (ops.kmedoids_build_cost(D, dn, vf, use_kernel=uk),)

    cases.append(("build_cost", "C=25 M=128 (fleet)", (25, 128), run,
                  4.0 * (25 * 128 * 128 + 3 * 25 * 128),
                  3.0 * 25 * 128 * 128, None))
    for c, m, ks in ((1, 37, (1, 7)), (1, 1000, (1, 7, 130, 700)),
                     (1, 2048, (1, 7, 130, 700)), (25, 128, (64,))):
        D = torch.rand(c, m, m, generator=g, device=dev)
        d1 = torch.rand(c, m, generator=g, device=dev)
        d2 = d1 + torch.rand(c, m, generator=g, device=dev)
        vf = (torch.rand(c, m, generator=g, device=dev) < 0.9).float()
        for k in ks:
            idx = torch.randint(0, k, (c, m), generator=g, device=dev)
            oh = torch.nn.functional.one_hot(idx, k).float()

            def run(uk, D=D, d1=d1, d2=d2, vf=vf, oh=oh):
                return ops.kmedoids_delta_sweep(D, d1, d2, vf, oh,
                                                use_kernel=uk)

            # the data's work: 8 elementwise operations and one A add per
            # (i, j), and one multiply-add per nonzero of the one-hot
            nnz = float((oh != 0).sum())
            label = (f"M={m} K={k}" if c == 1
                     else f"C={c} M={m} K={k} (fleet)")
            cases.append(("delta_sweep", label,
                          (m, k) if c == 1 else (c, m, k), run,
                          4.0 * c * (m * m + 4 * m + 2 * m * k),
                          9.0 * c * m * m + 2.0 * nnz * m, None))

    # the fleet's kernels: per-client pairwise stacks below the cutover,
    # the distance-free BUILD and Δ-sweep at and above it, at SmallCNN's
    # feature width
    # C=25, M=128 is the fleet's group below the cutover (phase 6)
    for c, m, d in ((16, 128, FEATS), (3, 37, 60), (25, 128, FEATS)):
        x = torch.randn(c, m, d, generator=g, device=dev)

        def run(uk, x=x):
            return (ops.pairwise_l2_batched(x, zero_diag=True,
                                            use_kernel=uk),)

        def lib(x=x):
            return torch.cdist(x, x)

        # epilogue: add, multiply, subtract, max, sqrt per output
        cases.append(("pairwise_l2_batched", f"C={c} M={m} D={d}"
                      + (" (fleet)" if c == 25 else ""), (c, m),
                      run, 4.0 * (c * m * d + c * m * m),
                      2.0 * c * m * m * d + 5.0 * c * m * m, lib))
    # C=22, M=256, K=64 is the fleet's main distance-free group (phase 6)
    for c, m, padded, ks in ((4, 512, False, (1, 7, 130)),
                             (4, 512, True, (7,)),
                             (1, 2048, False, (1, 7, 130)),
                             (22, 256, False, (64,))):
        x = torch.randn(c, m, FEATS, generator=g, device=dev)
        vf = torch.ones(c, m, device=dev)
        if padded:      # ragged clients: a zeroed tail of padded rows
            n = torch.randint(m // 2, m + 1, (c,), generator=g, device=dev)
            vf = (torch.arange(m, device=dev)[None] < n[:, None]).float()
            x = x * vf[..., None]
        dn = 60.0 * torch.rand(c, m, generator=g, device=dev)
        tag = (f"C={c} M={m}" + (" padded" if padded else "")
               + (" (fleet)" if (c, m) == (22, 256) else ""))

        def run(uk, x=x, dn=dn, vf=vf):
            return (ops.kmedoids_build_cost_from_feats(x, dn, vf,
                                                       use_kernel=uk),)

        # per (i, j): the 2F dot, 5 epilogue and 3 BUILD operations
        cases.append(("build_cost_from_feats", tag, (c, m), run,
                      4.0 * (c * m * FEATS + 3 * c * m),
                      (2.0 * FEATS + 8.0) * c * m * m, None))
        d1 = 60.0 * torch.rand(c, m, generator=g, device=dev)
        d2 = d1 + 10.0 * torch.rand(c, m, generator=g, device=dev)
        for k in ks:
            idx = torch.randint(0, k, (c, m), generator=g, device=dev)
            oh = torch.nn.functional.one_hot(idx, k).float()

            def run(uk, x=x, d1=d1, d2=d2, vf=vf, oh=oh):
                return ops.kmedoids_delta_sweep_from_feats(
                    x, d1, d2, vf, oh, use_kernel=uk)

            # per (i, j): the 2F dot, 5 epilogue, 4 A and 4 contrib
            # operations; one multiply-add per one-hot nonzero and j
            nnz = float((oh != 0).sum())
            cases.append(("delta_sweep_from_feats", f"{tag} K={k}",
                          (c, m, k), run,
                          4.0 * (c * m * FEATS + 4 * c * m + 2 * c * m * k),
                          (2.0 * FEATS + 13.0) * c * m * m
                          + 2.0 * nnz * m, None))
    return cases


def phase_kernels(dev):
    results = {}
    for name, label, key, run, nbytes, nops, lib in kernel_cases(dev):
        got, want = run(True), run(False)
        errs = [compare(a, b) for a, b in zip(got, want)]
        max_abs = max(e[0] for e in errs)
        max_rel = max(e[1] for e in errs)
        ok = all(e[2] for e in errs)
        ms = time_ms(lambda: run(True))
        plain_ms = time_ms(lambda: run(False))
        lib_ms = time_ms(lib) if lib is not None else None
        b_ms, b_by = bound(nbytes, nops)
        lib_s = ("none (no single PyTorch call computes it)"
                 if lib_ms is None else f"{lib_ms:.4f} ms")
        log(f"  {name:22s} {label:22s} max_abs {max_abs:.3e} max_rel "
            f"{max_rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {lib_s} "
            f"bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'MISMATCH'}")
        check(ok, f"{name} {label}: kernel disagrees with its plain version "
              f"(max abs {max_abs:.3e})")
        r = results.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], max_abs)
        if key == HEADLINE[name]:
            r.update(shape=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, library_ms=lib_ms)
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
    out, strat, records, launches, wall = run_fl(model, clients, cfg)
    devices, sel_s, round_s = report_rounds(out, records)
    log(f"  wall {wall:.2f} s; selection {sel_s:.3f} s of {round_s:.3f} s "
        f"in rounds ({100 * sel_s / max(round_s, 1e-12):.1f}%); "
        f"{len(strat.selected)} coresets, budgets "
        f"{[b for _, b, _ in strat.selected]} of m "
        f"{[len(f) for f, _, _ in strat.selected]}")
    log(f"  launches on the main path: {launches}")
    check(len(strat.selected) > 0, "no coreset was built on the main path")
    check(all(launches[k] > 0 for k in SYNC_KERNELS),
          f"a kernel never launched on the main path: {launches}")
    check(all(str(d).startswith("cuda") for d in devices),
          f"a coreset was built off the card: {devices}")
    check_params(out)
    return clients, cfg, out, strat, launches


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
    """Run ``fn`` under ``torch.profiler``; returns (wall s, device busy
    s, {device activity name: s}) with busy the union of the card's
    kernel and copy intervals, or None for busy when the profiler saw no
    device activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in dev_events:
        by_name[e.name] = (by_name.get(e.name, 0.0)
                           + (e.time_range.end - e.time_range.start) * 1e-6)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in dev_events)
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
    return wall, busy * 1e-6, by_name


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


def phase_fleet():
    import numpy as np
    import torch

    from repro_torch.fed.fleet import (FleetConfig, client_sizes,
                                       make_cohort_groups, nominal_budgets,
                                       run_fleet)
    from repro_torch.fed.simulator import (make_client_specs,
                                           straggler_deadline)

    wl = cnn_fleet_workload()
    clients = wl.make_clients()
    wl.validate_clients(clients)
    specs = make_client_specs(client_sizes(clients),
                              np.random.default_rng(0))
    cfg = FleetConfig(epochs=5, batch_size=8, lr=0.03)
    deadline = straggler_deadline(specs, cfg.epochs, 30.0)
    groups = make_cohort_groups(
        clients, list(range(len(clients))),
        nominal_budgets(specs, deadline, cfg.epochs), cfg)
    log("  groups (M, k, C): " + ", ".join(
        f"({g.valid.shape[1]}, {g.k}, {g.n_clients})" for g in groups))
    sel_m = [g.valid.shape[1] for g in groups if g.k > 0]
    check(any(m < cfg.materialize_below for m in sel_m)
          and any(m >= cfg.materialize_below for m in sel_m),
          f"no selection groups on both sides of M = "
          f"{cfg.materialize_below}: {sel_m}")

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
    check(all(launches[k] > 0 for k in FLEET_KERNELS),
          f"a fleet kernel never launched on the fleet path: {launches}")
    check(launches["pairwise_l2"] == 0,
          f"the fleet path launched the single-matrix pairwise kernel: "
          f"{launches}")
    check(all(h.n_coreset > 0 for h in out["history"]),
          "a fleet round built no coreset")
    check_params(out)

    # three more one-round runs, alike but for what watches them: bare
    # (the wall), with CUDA events around the selection's parts, and
    # under torch.profiler (the card's busy time; the profiler inflates
    # the wall, so the idle share is taken against the bare one)
    def one_round():
        return run_fleet(wl, clients, specs, cfg, 1, straggler_pct=30.0)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    torch.cuda.synchronize()
    bare_wall = time.perf_counter() - t0
    log(f"  one more round, bare: wall {bare_wall:.3f} s")
    ewall, parts = stream_time_by_part(one_round)
    log(f"  stream time by part (one more round with CUDA events, wall "
        f"{ewall:.3f} s): " + ", ".join(
            f"{part} {n} calls {t:.3f} s ({100 * t / bare_wall:.1f}% of "
            f"the bare round)" for part, (n, t) in parts.items()))
    pwall, busy, by_name = device_busy_share(one_round)
    if busy is None:
        log("  device busy share: not measured (the profiler saw no "
            "device activity)")
    else:
        log(f"  device busy (one more round under torch.profiler, wall "
            f"{pwall:.3f} s): busy {busy:.3f} s; idle "
            f"{100 * (1 - busy / bare_wall):.1f}% of the bare round's wall "
            f"{bare_wall:.3f} s ({100 * (1 - busy / pwall):.1f}% of the "
            f"profiled round's)")
        log("  device time by activity, top 8: " + "; ".join(
            f"{name[:60]} {t:.3f} s ({100 * t / busy:.1f}%)"
            for name, t in sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:8]))
    return wl, clients, specs, cfg, kept, launches


def phase_fleet_ab(wl, clients, specs, cfg, kept):
    import dataclasses

    import torch

    _, pkept, _, plaunches, pwall = run_fleet_recorded(
        wl, clients, specs, dataclasses.replace(cfg, use_kernel=False), 3,
        "batched")
    log(f"  plain run: wall {pwall:.2f} s, launches {plaunches}")
    check(all(n == 0 for n in plaunches.values()),
          f"use_kernel=False launched a kernel: {plaunches}")
    check(len(pkept) == len(kept), "the plain run ran another round count")
    for r, ((km, kp), (pm, pp)) in enumerate(zip(kept, pkept)):
        check(set(km) == set(pm), f"round {r}: other clients selected")
        diff = [c for c in km if not (km[c] == pm[c]).all()]
        check(not diff, f"round {r}: kernel and plain medoids differ for "
              f"clients {diff}")
        same = all(torch.equal(kp[k], pp[k]) for k in kp)
        check(same, f"round {r}: kernel and plain params are not "
              "bit-identical")
    log(f"  {sum(len(m) for m, _ in kept)} coresets equal per (round, "
        f"client); params bit-identical after every round")

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
        f"max abs diff {max_diff:.3e} (PARAMS_ATOL {PARAMS_ATOL_CNN})")
    check(max_diff <= PARAMS_ATOL_CNN,
          f"loop and batched params differ by {max_diff:.3e}")


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
    t_start = time.perf_counter()

    log("== phase 1: set-up")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"{torch.cuda.get_device_name(0)}, power limit not read"
    log(f"  card: {card}")
    log(f"  python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic cuDNN: the kernel and plain runs of phases 3 and 4
    # must train bit for bit alike, or a last-bit difference in the
    # parameters reaches the next round's medoid choice
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
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
    dev = torch.device("cuda")

    phases = {}
    t = time.perf_counter()
    log("== phase 2: kernels against their plain versions (rtol 1e-5, "
        "atol 1e-5*max|plain|)")
    kernels = phase_kernels(dev)
    phases["kernels"] = time.perf_counter() - t

    t = time.perf_counter()
    log("== phase 3: main path, FedCore on SmallCNN (28x28, 16/32, "
        "F=1568), 200 clients, 3 rounds x 10 clients, E=5")
    clients, cfg, kout, kstrat, launches = phase_main_path()
    phases["main_path"] = time.perf_counter() - t

    t = time.perf_counter()
    log("== phase 4: the same run with use_kernel=False")
    phase_plain_ab(clients, cfg, kout, kstrat)
    phases["plain_ab"] = time.perf_counter() - t

    t = time.perf_counter()
    log("== phase 5: the other paper models")
    phase_other_models()
    phases["other_models"] = time.perf_counter() - t

    t = time.perf_counter()
    log("== phase 6: fleet main path, run_fleet(engine='batched') on "
        "SmallCNN (28x28, 16/32, F=1568), 200 clients, every client every "
        "round, 3 rounds, E=5")
    wl, fclients, fspecs, fcfg, fkept, flaunches = phase_fleet()
    phases["fleet"] = time.perf_counter() - t

    t = time.perf_counter()
    log("== phase 7: fleet A/Bs, use_kernel=False and engine='loop'")
    phase_fleet_ab(wl, fclients, fspecs, fcfg, fkept)
    phases["fleet_ab"] = time.perf_counter() - t

    log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      phases.items())
        + f"; total {time.perf_counter() - t_start:.1f}")
    line = {"kernels": []}
    by_path = {"sync": launches, "fleet": flaunches}
    for name, (source, replaces) in KERNEL_META.items():
        k = kernels[name]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": by_path[PATH_OF[name]][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "shape": k["shape"], "path": PATH_OF[name],
            "launches_by_path": {p: c[name] for p, c in by_path.items()}})
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as exc:
        print(f"chip_smoke.py: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
