#!/usr/bin/env python3
"""Time the pairwise-distance kernels (kernels 1 and 4) at the main paths'
shapes, and each of their tile configurations.

    python3 tools/pairwise_tiles.py [--src DIR] [--tiles] [--json FILE]

On a machine with one CUDA card.  For each case (kernel 1 in self mode,
squared, with a zero diagonal, as the sync path calls it; kernel 4 with a
zero diagonal, as the fleet calls it below the distance-free cutover) it
prints the wrapper's time a call (CUDA events over back-to-back calls),
the pairwise kernel's own device time a call (``torch.profiler``, 20
calls), and the same two for ``torch.cdist``, the one PyTorch call that
computes the function (squared for kernel 1), on the same inputs in the
same process.  ``--tiles`` also runs every tile configuration of
``ops.PAIRWISE_TILES``: each must equal the plain version bit for bit,
and its device time is printed beside the one the wrapper's chooser
picks; it adds the shapes of ``SWEEP``.  ``--src`` imports
``repro_torch`` from another checkout's ``src`` (to time two trees on
one card: run parent, change, change, parent); a tree without tile
configurations is timed as its wrapper runs.  ``--json`` writes the numbers.  TF32 is off.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (C, M, D): C = 0 is kernel 1 on one (M, D) matrix; the sync path's
# largest and median client (341, 39), phase 2's cases, the CNN fleet's
# groups below the cutover (D = 1568) and the char-LM fleets' (D = 32)
CASES = ((0, 37, 60), (0, 39, 1568), (0, 341, 1568), (0, 1000, 1568),
         (0, 2048, 1568), (0, 2048, 128),
         (16, 128, 1568), (3, 37, 60), (25, 128, 1568), (8, 16, 1568),
         (2, 32, 32), (6, 32, 32), (4, 64, 32), (5, 64, 32), (1, 128, 32),
         (11, 128, 32), (7, 128, 32))
# more shapes for --tiles, to see where each configuration wins
SWEEP = ((0, 10, 1568), (0, 64, 1568), (0, 128, 1568), (0, 200, 1568),
         (0, 273, 1568), (0, 500, 1568), (0, 700, 1568), (0, 1400, 1568),
         (2, 16, 1568), (50, 128, 1568), (3, 256, 1568))
PROFILED_CALLS = 20


def events_ms(fn, target_ms: float = 60.0) -> float:
    """Mean time of one call by CUDA events over back-to-back calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    reps = int(max(5, min(400, target_ms / max(start.elapsed_time(end),
                                               1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, match=None):
    """Device time a call under ``torch.profiler`` over PROFILED_CALLS
    calls: the summed time of the kernels whose name holds ``match``, or
    the card's busy time (the union of every kernel's interval) when
    ``match`` is None.  None when the profiler saw nothing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    ev = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
          for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    if match is not None:
        ev = [e for e in ev if match in e[0]]
        total = sum(b - a for _, a, b in ev)
    else:
        spans, total, end = sorted((a, b) for _, a, b in ev), 0, None
        for a, b in spans:
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
    return total * 1e-6 / PROFILED_CALLS if ev else None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("pairwise_tiles.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build, ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    tree = str(Path(ops.__file__).parents[2])
    print(f"card: {card}; torch {torch.__version__}; repro_torch from "
          f"{tree}", flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    tiles = getattr(ops, "PAIRWISE_TILES", None)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    # the first profiler session of a process may see no device activity
    device_ms(lambda: torch.ones(1, device=dev).sum())
    rows = []
    for c, m, d in CASES + (SWEEP if args.tiles and tiles else ()):
        x = torch.randn(max(c, 1), m, d, generator=g, device=dev)
        if c == 0:
            x = x[0]

            def run(uk=None, tile=None, x=x):
                if tile is not None:
                    return ops._pairwise_l2_launch(x, None, True, True,
                                                   tile)
                return ops.pairwise_l2(x, squared=True, zero_diag=True,
                                       use_kernel=uk)

            def lib(x=x):
                return torch.cdist(x, x).square()
            label = f"kernel 1, m={m} d={d}"
        else:
            def run(uk=None, tile=None, x=x):
                if tile is not None:
                    return ops._pairwise_l2_batched_launch(x, False, True,
                                                           tile)
                return ops.pairwise_l2_batched(x, zero_diag=True,
                                               use_kernel=uk)

            def lib(x=x):
                return torch.cdist(x, x)
            label = f"kernel 4, C={c} M={m} D={d}"
        want = run(False)
        ok = torch.equal(run(), want)
        row = {"case": label, "c": c, "m": m, "d": d, "exact": ok,
               "ms": events_ms(run),
               "device_ms": device_ms(run, "pairwise_l2_kernel"),
               "busy_ms": device_ms(run),
               "library_ms": events_ms(lib),
               "library_device_ms": device_ms(lib)}
        if tiles is not None:
            chosen = ops.pairwise_tile(max(c, 1), m, m, True,
                                       ops.card_sms(dev))
            row["tile"] = list(tiles[chosen])
            if args.tiles:
                row["tiles"] = {}
                for t, cfg in enumerate(tiles):
                    same = torch.equal(run(tile=t), want)
                    ok = ok and same
                    row["tiles"][str(cfg)] = {
                        "exact": same,
                        "device_ms": device_ms(lambda t=t: run(tile=t),
                                               "pairwise_l2_kernel"),
                        "blocks": ops.pairwise_grid(max(c, 1), m, m, t,
                                                    True)}
        row["exact"] = ok
        rows.append(row)
        fmt = (lambda v: "not measured" if v is None else f"{v:.4f}")
        line = (f"{label:32s} exact {ok} ms {row['ms']:.4f} device "
                f"{fmt(row['device_ms'])} busy {fmt(row['busy_ms'])} "
                f"cdist {row['library_ms']:.4f} device "
                f"{fmt(row['library_device_ms'])}")
        if "tile" in row:
            line += f" tile {tuple(row['tile'])}"
        print(line, flush=True)
        for cfg, r in row.get("tiles", {}).items():
            print(f"    tile {cfg}: {r['blocks']} blocks, device "
                  f"{fmt(r['device_ms'])}, exact {r['exact']}", flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "tree": tree, "rows": rows}, indent=1))
    bad = [r["case"] for r in rows if not r["exact"]]
    if bad:
        print(f"pairwise_tiles.py: kernel differs from its plain version: "
              f"{bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
